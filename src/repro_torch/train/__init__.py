"""Checkpoints (counterpart of ``repro.train``): msgpack-framed numpy
arrays that either package restores."""
from repro_torch.train import checkpoint  # noqa: F401
