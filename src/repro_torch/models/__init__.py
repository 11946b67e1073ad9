"""The model path: parameter specs, blocks and the prefill/decode steps of
the JAX package's ``repro.models``, in PyTorch. The port carries the SSM
family (Mamba-2) and the dense family (attention); MoE, hybrid and
enc-dec wait for their slices (``ROADMAP.md``)."""
