"""Sharded npz checkpoints with an atomic commit (``checkpoint.ckpt``)."""
