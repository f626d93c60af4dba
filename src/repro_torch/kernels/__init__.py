"""Hand-written CUDA kernels for Hopper (counterpart of ``repro.kernels``).

Each kernel package holds the CUDA source (``csrc/``), a plain PyTorch
version of the same function (``ref.py``) and the wrapper (``ops.py``) that
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors.  ``_build`` compiles the sources at first use.
"""

#: The CUDA libraries ``_build`` knows: name -> source, relative to this
#: package.  ``rolann_stats`` holds B1 and B2; ``rolann_fused_chunk`` holds
#: B3.  A ``*.cuh`` header beside a source is part of it.
KERNELS = {
    "rolann_stats": "rolann_stats/csrc/rolann_stats.cu",
    "rolann_fused_chunk": "rolann_stats/csrc/rolann_fused_chunk.cu",
}
