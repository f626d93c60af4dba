"""Hand-written CUDA kernels for Hopper (counterpart of ``repro.kernels``).

Each kernel package holds the CUDA source (``csrc/``), a plain PyTorch
version of the same function (``ref.py``) and the wrapper (``ops.py``) that
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors.  ``_build`` compiles the sources at first use.
"""

#: The CUDA libraries ``_build`` knows: name -> source, relative to this
#: package.  ``rolann_stats`` holds B1, B2, B4 and B5; ``rolann_fused_chunk``
#: holds B3 and B6; ``flash_attention`` B7, the attention forward;
#: ``flash_attention_bwd`` B8, its backward; ``rglru_scan`` B9; ``ssd_chunk``
#: B10; ``rglru_scan_bwd`` and ``ssd_chunk_bwd`` the backwards of B9 and
#: B10 (no Pallas counterpart: the reference differentiates plain XLA).  A
#: ``*.cuh`` header beside a source is part of it.
KERNELS = {
    "rolann_stats": "rolann_stats/csrc/rolann_stats.cu",
    "rolann_fused_chunk": "rolann_stats/csrc/rolann_fused_chunk.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "flash_attention_bwd": "flash_attention/csrc/flash_attention_bwd.cu",
    "rglru_scan": "rglru_scan/csrc/rglru_scan.cu",
    "ssd_chunk": "ssd_chunk/csrc/ssd_chunk.cu",
    "rglru_scan_bwd": "rglru_scan/csrc/rglru_scan_bwd.cu",
    "ssd_chunk_bwd": "ssd_chunk/csrc/ssd_chunk_bwd.cu",
}
