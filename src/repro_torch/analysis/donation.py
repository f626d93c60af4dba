"""Donation verification: does a buffer the caller hands over get reused?
(counterpart of ``repro/analysis/donation.py``).

In the reference, ``donate_argnums`` asks XLA to alias an input's buffer
with an output, and whether it does depends on the backend; its probe reads
the answer out of the compiled executable.  A torch program has no
compiler to ask.  Its counterparts of a donation are what the port's hot
paths do on purpose:

* an accumulator updated **in place** — the streaming folds
  (`core.daef._stream_layer_step`) add each chunk's (G, M) into the running
  statistics' own storage;
* a buffer whose **storage an output reuses** — an output that is the
  input, or a view of it;
* a CUDA graph's **static input** — the fleet server's tile buffer, which
  every dispatch of a shape refills (`serving.server.FleetServer
  .probe_donation` reports it in this same class).

:func:`probe` calls the function once and reads the first two facts off
the tensors themselves: an argument in ``donate_argnums`` is effective
when an output shares its storage (``untyped_storage().data_ptr()``) or
when the call bumped its version counter (``_version``, what autograd
reads to detect in-place updates).

    >>> rep = probe(daef._stream_layer_step, cfg, stats, params, x, mask,
    ...             donate_argnums=(1,))
    >>> rep.requested, rep.effective_params, rep.ok
    ((1,), (1,), True)

The reference's ``suppress_unusable_donation_warning`` has no torch
meaning (torch emits no "donated buffers were not usable" warning) and is
not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DonationReport:
    """Outcome of one donation probe at one call site on one device type.

    ``requested`` and ``effective_params`` are argument positions;
    ``kinds`` says per effective argument how it was reused
    (``"in-place"``, ``"storage-reused"``, ``"graph-static-input"``);
    ``warned`` is kept for the reference's fields and is always False (no
    torch warning to absorb)."""

    fn_name: str
    backend: str
    requested: tuple[int, ...]        # argument positions asked to donate
    effective_params: tuple[int, ...] | None  # argument positions reused
    kinds: tuple[str, ...]            # how each effective argument was reused
    warned: bool

    @property
    def ok(self) -> bool | None:
        """True iff every requested donation is honoured; None when nothing
        could be observed (nothing requested, or no reuse to observe on
        this device)."""
        if self.warned:
            return False
        if self.effective_params is None:
            return None
        return set(self.requested) <= set(self.effective_params)

    @property
    def dropped(self) -> tuple[int, ...]:
        """Requested-but-not-honoured argument positions."""
        if self.effective_params is None:
            return ()
        return tuple(sorted(set(self.requested) - set(self.effective_params)))

    def describe(self) -> str:
        """One log-line summary of the probed fact."""
        if self.effective_params is None:
            state = ("unknown (nothing to observe: no donation requested, or "
                     "no CUDA graph holds the buffer on this device)")
        elif self.ok:
            state = (f"effective ({len(self.requested)}/{len(self.requested)} "
                     f"donated inputs reused: {', '.join(self.kinds)})")
        else:
            state = f"NOT effective (inputs {self.dropped} copy instead of reuse)"
        return f"donation probe [{self.fn_name} on {self.backend}]: {state}"


def _tensors(tree) -> list[torch.Tensor]:
    """The tensor leaves of a tensor, tuple, list, dict or NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in _tensors(item)]
    return []


def probe(fn, *args, donate_argnums=(), **kwargs) -> DonationReport:
    """Call ``fn(*args, **kwargs)`` once and report which of the arguments
    at ``donate_argnums`` it reused.

    An argument (a tensor, or a tuple / NamedTuple / list / dict of them) is
    effective when every tensor in it either shares its storage with a
    tensor of the output or was updated in place by the call (its
    ``_version`` moved).  With nothing requested, ``effective_params`` is
    None and ``ok`` None.  The call runs for real, so a function that
    updates its arguments in place updates them.  A CUDA kernel that writes
    through a raw pointer (the port's ctypes wrappers) moves no version
    counter by itself; the streaming folds' wrappers (B2, B3, B5, B6) bump
    their float32 accumulators' versions after the launch, so their folds
    show as "in-place" on the card as on the host.

    Raises:
        TypeError: a position in ``donate_argnums`` that is not an argument
            holding tensors.
    """
    requested = tuple(int(i) for i in donate_argnums)
    donated = {}
    for i in requested:
        if not 0 <= i < len(args) or not _tensors(args[i]):
            raise TypeError(f"probe: donate_argnums names argument {i}, which holds no "
                            f"tensor (of {len(args)} positional arguments)")
        donated[i] = [(t, t._version) for t in _tensors(args[i])]
    tensors = _tensors(list(args)) + _tensors(kwargs)
    backend = tensors[0].device.type if tensors else "cpu"
    out = fn(*args, **kwargs)
    if not requested:
        effective, kinds = None, ()
    else:
        out_storage = {t.untyped_storage().data_ptr() for t in _tensors(out)}
        effective, kinds = [], []
        for i, leaves in donated.items():
            moved = [t._version != v for t, v in leaves]
            shared = [t.untyped_storage().data_ptr() in out_storage for t, _ in leaves]
            if all(m or s for m, s in zip(moved, shared, strict=True)):
                effective.append(i)
                kinds.append("in-place" if any(moved) else "storage-reused")
        effective, kinds = tuple(effective), tuple(kinds)
    return DonationReport(
        fn_name=getattr(fn, "__name__", str(fn)), backend=backend,
        requested=requested, effective_params=effective, kinds=kinds, warned=False,
    )


__all__ = ["DonationReport", "probe"]
