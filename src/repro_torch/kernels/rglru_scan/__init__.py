"""RG-LRU linear recurrence (B9): CUDA kernel, wrapper and plain version."""
from repro_torch.kernels.rglru_scan.ops import RGLRUScan, rglru_scan, rglru_scan_bwd
from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_plain, rglru_scan_ref

__all__ = ["RGLRUScan", "rglru_scan", "rglru_scan_bwd", "rglru_scan_bwd_plain",
           "rglru_scan_ref"]
