"""The model path: parameter specs, blocks and the prefill/decode steps of
the JAX package's ``repro.models``, in PyTorch. The port carries the SSM
family (Mamba-2), the dense family (attention) and the MoE family
(``moe``); hybrid and enc-dec wait for their slices (``ROADMAP.md``)."""
