"""The model path: parameter specs, blocks and the prefill/decode steps of
the JAX package's ``repro.models``, in PyTorch. This slice carries the SSM
family (Mamba-2); attention, MoE, hybrid and enc-dec wait for their slices
(``ROADMAP.md``)."""
