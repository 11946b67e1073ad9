"""The model path: parameter specs, blocks and the prefill/decode steps of
the JAX package's ``repro.models``, in PyTorch. The port carries the SSM
family (Mamba-2), the dense family (attention), the MoE family (``moe``),
the hybrid family (Jamba) and the enc-dec family (Whisper, ``encdec``),
and the loss each family trains on (``training``)."""
