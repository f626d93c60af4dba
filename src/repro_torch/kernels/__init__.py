"""Hand-written CUDA kernels for Hopper (counterpart of ``repro.kernels``).

Each kernel package holds the CUDA source (``csrc/``), a plain PyTorch
version of the same function (``ref.py``) and the wrapper (``ops.py``) that
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors.  ``_build`` compiles the sources at first use.
"""

#: Kernel names, as ``_build`` knows them (``<name>/csrc/<name>.cu``).
KERNELS = ("rolann_stats",)
