"""Architecture configs (one module per assigned arch) + registry.

Counterpart of ``repro.configs``: the same dataclass literals, copied so that
the port imports nothing of the JAX package.  ``registry.get(name)`` looks an
architecture up; ``ArchConfig.reduced()`` gives its smoke-test variant.
"""
from repro_torch.configs.base import ArchConfig  # noqa: F401
