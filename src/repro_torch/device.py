"""Device and dtype policy of the port.

* ``device=None`` means the CUDA card.  Without one, :func:`resolve_device`
  raises: an entry point never falls back to the CPU on its own.  The CPU is
  used only when a caller asks for it (``device="cpu"``).
* float32 by default.  A floating torch tensor keeps its dtype (float64 is
  allowed); numpy arrays and integer inputs become float32, as ``jnp.asarray``
  makes them with JAX's default 32-bit mode.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DTYPE = torch.float32


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the card for ``None``, else ``device``.

    Raises:
        RuntimeError: ``device`` is ``None`` or a CUDA device and no card is
            present.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA card by default and none is "
                "present; pass device='cpu' to run on the host"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA card is present")
    return dev


def as_tensor(
    x, device: torch.device, dtype: torch.dtype | None = None
) -> torch.Tensor:
    """``x`` (tensor, numpy array or nested list) as a tensor on ``device``.

    ``dtype=None`` keeps a floating tensor's dtype and makes everything else
    float32 (the port's default).
    """
    if dtype is None:
        is_float = isinstance(x, torch.Tensor) and x.is_floating_point()
        dtype = x.dtype if is_float else DEFAULT_DTYPE
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = np.array(x)  # torch.as_tensor warns on read-only buffers
    return torch.as_tensor(x, dtype=dtype, device=device)
