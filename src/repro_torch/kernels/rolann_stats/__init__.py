"""Fused ROLANN sufficient statistics: CUDA kernel, wrapper and plain version."""
from repro_torch.kernels.rolann_stats.ops import rolann_stats, rolann_stats_plain
from repro_torch.kernels.rolann_stats.ref import rolann_stats_ref

__all__ = ["rolann_stats", "rolann_stats_plain", "rolann_stats_ref"]
