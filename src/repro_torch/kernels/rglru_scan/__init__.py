"""RG-LRU linear recurrence (B9): CUDA kernel, wrapper and plain version."""
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

__all__ = ["rglru_scan", "rglru_scan_ref"]
