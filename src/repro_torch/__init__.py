"""FlashMem in PyTorch for an NVIDIA Hopper card.

The same planning, streaming and serving stack as the JAX package
``repro``, with the compute on a CUDA device: every projection runs through
the hand-written ``streamed_matmul`` kernel and every attention through
``flash_attention`` (``kernels/csrc``). The device is explicit
(``device.resolve_device``): entry points run on ``cuda:0`` and raise when
no card is present, unless the caller asks for ``"cpu"``, where the
kernels' plain PyTorch versions run instead.
"""
