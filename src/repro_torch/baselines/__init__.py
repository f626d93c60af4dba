"""Baselines the paper compares against (iterative deep autoencoder);
counterpart of ``repro/baselines``."""
from repro_torch.baselines import autoencoder  # noqa: F401
from repro_torch.baselines.autoencoder import AEConfig, AEModel  # noqa: F401
