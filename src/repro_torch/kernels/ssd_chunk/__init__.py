"""Mamba-2 SSD chunked scan (B10): CUDA kernel, wrapper and plain versions."""
from repro_torch.kernels.ssd_chunk.ops import SSDChunk, fit_chunk, ssd_chunk, ssd_chunk_bwd
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_bwd_plain, ssd_chunk_plain, ssd_chunk_ref

__all__ = ["SSDChunk", "fit_chunk", "ssd_chunk", "ssd_chunk_bwd", "ssd_chunk_bwd_plain",
           "ssd_chunk_plain", "ssd_chunk_ref"]
