"""Fused ROLANN sufficient statistics: CUDA kernels, wrappers and plain versions
(B1 ``rolann_stats``, B2 ``rolann_stats_acc``, B3 ``rolann_fused_chunk``, and
their tenant-batched twins B4 ``rolann_stats_batched``, B5
``rolann_stats_acc_batched``, B6 ``rolann_fused_chunk_batched``)."""
from repro_torch.kernels.rolann_stats.ops import (
    rolann_fused_chunk,
    rolann_fused_chunk_batched,
    rolann_fused_chunk_batched_plain,
    rolann_fused_chunk_plain,
    rolann_stats,
    rolann_stats_acc,
    rolann_stats_acc_batched,
    rolann_stats_acc_batched_plain,
    rolann_stats_acc_plain,
    rolann_stats_batched,
    rolann_stats_batched_plain,
    rolann_stats_plain,
)
from repro_torch.kernels.rolann_stats.ref import rolann_stats_ref

__all__ = [
    "rolann_fused_chunk",
    "rolann_fused_chunk_batched",
    "rolann_fused_chunk_batched_plain",
    "rolann_fused_chunk_plain",
    "rolann_stats",
    "rolann_stats_acc",
    "rolann_stats_acc_batched",
    "rolann_stats_acc_batched_plain",
    "rolann_stats_acc_plain",
    "rolann_stats_batched",
    "rolann_stats_batched_plain",
    "rolann_stats_plain",
    "rolann_stats_ref",
]
