"""Hand-written CUDA kernels for the port (``csrc/``), their ctypes
wrappers, their plain PyTorch versions (``ref``) and the device dispatch
(``ops``)."""
