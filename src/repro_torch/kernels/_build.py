"""Build and load the port's hand-written CUDA kernels.

Each library named in ``repro_torch.kernels.KERNELS`` is one CUDA source
under a kernel package's ``csrc/`` that exports plain C functions.  At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/repro_torch/`` at the root of the checkout, and loaded
with ``ctypes``.  The library's file name carries a hash of the source, of
every header it can include (``#include "..."``, followed from file to file,
also into another kernel's ``csrc/``) and of the flags, so an edited source
or header is rebuilt and a stale library is never loaded.

Nothing here runs at import: importing the port on a machine without
``nvcc`` or a card never tries to build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from repro_torch.analysis import retrace

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def source(name: str) -> Path:
    from repro_torch.kernels import KERNELS

    return KERNELS_DIR / KERNELS[name]


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def includes(path: Path) -> list[Path]:
    """Every file that ``path`` can include with ``#include "..."``, directly
    or through another include, each resolved beside the file that includes
    it; in the order found, each file once."""
    found: list[Path] = []
    todo = [path.resolve()]
    while todo:
        current = todo.pop(0)
        for rel in _INCLUDE.findall(current.read_text()):
            dep = (current.parent / rel).resolve()
            if dep.is_file() and dep not in found:
                found.append(dep)
                todo.append(dep)
    return found


def library_path(name: str) -> Path:
    src = source(name)
    digest = hashlib.sha256(src.read_bytes())
    for header in includes(src):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    candidates += [Path(found)] if found else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start compiling ``name`` unless its library exists; returns the
    target, the temporary output and the running compiler."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return target, tmp, proc


def _finish(name: str, started: tuple[Path, Path, subprocess.Popen]) -> None:
    target, tmp, proc = started
    out, _ = proc.communicate()
    target.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


def build(*names: str) -> dict[str, Path]:
    """Compile every named kernel that is not built yet, all at once (one
    ``nvcc`` each, started together), and return their library paths."""
    started = {n: _start(n) for n in names}
    try:
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    finally:
        for s in started.values():
            if s is not None and s[2].poll() is None:
                s[2].kill()
                s[2].wait()
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """What ``nvcc`` printed for the current build (``ptxas -v`` lines)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed.  Each open
    counts one load on `analysis.retrace`'s recorder."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build(name)[name]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
        retrace.record(retrace.LIBRARY_LOAD_EVENT, name)
    return lib


def clear_loaded() -> None:
    """Forget every loaded library, so the next call of each opens it again
    and counts a load (the counterpart of ``jax.clear_caches()`` in the
    reference's cold trace counts).  The libraries stay built on disk."""
    _LOADED.clear()


def function(library: str, name: str, argtypes):
    """The C function ``name`` of ``library``, returning an int error code,
    with its argument types set (ctypes passes an unset pointer as a 32-bit
    int)."""
    fn = getattr(load(library), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def raise_on(who: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error {err}")


def launch(library: str, name: str, argtypes, device, *args) -> None:
    """Call the C entry point ``name`` of ``library`` with ``args`` and then
    the raw handle of PyTorch's current stream on ``device`` (every entry
    point's last argument), with ``device`` the current CUDA device; raise
    if it returns a CUDA error.  The stream and device are read through
    torch's C API (as Triton's launcher reads the stream): the Python
    ``torch.cuda`` wrappers cost several microseconds a launch."""
    import torch

    fn = function(library, name, argtypes)
    index = device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if torch._C._cuda_getDevice() == index:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    raise_on(name, err)
