"""Device meshes of the port (counterpart of ``repro/launch/mesh.py``).

The reference's mesh is one controller's view of many devices.  The port
runs one process per device, a ``torch.distributed`` rank: every rank runs
the same program and keeps its own slice of the work.  A :class:`Mesh`
names the axes that slice it (``"tenants"``, ``"data"``, ``("pod",
"data")``, ``("data", "model")``), this rank's device and place, and runs
the few collectives the DAEF and LM mesh paths need.

* One rank: with no default process group, or for a mesh of one device,
  the mesh holds no process group and its collectives are the identity.
  This is the reference's one-device mesh.  A library call never starts a
  process group (:func:`init_process_group_from_file` is for launchers).
* Many ranks: the mesh spans every rank of the default group, as a
  ``DeviceMesh`` with the mesh's axis names, ranks in row-major order; its
  collectives run over the DeviceMesh's per-axis groups.  A multi-rank mesh
  spans all ranks or one: the port has no sub-meshes.

An axis of one rank runs no collective along it.  The LM layout
(``launch/shardings.py``, ``models/hints.py``) runs its collectives over
the per-axis groups of a ("data", "model") mesh.

Backends: NCCL on the card, gloo on the host.  Under gloo a CUDA tensor is
staged through pinned host memory, explicitly and only under gloo (four
gloo ranks may share one card, where NCCL refuses to put two ranks).
Sums over a mesh axis are an ``all_gather`` and a sum in rank order, never
``all_reduce``: the association is the same on gloo and NCCL and repeats
are bit-identical.

``make_production_mesh`` describes TPU v5e pods and has no torch meaning.
"""
from __future__ import annotations

import datetime
import math
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

TENANT_AXIS = "tenants"
DATA_AXIS_NAMES = ("pod", "data")


def world_size() -> int:
    """Ranks of the default process group; 1 when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for ``None`` or ``"cuda"``
    (the card), else ``device``."""
    dev = resolve_device(device)  # raises without a card
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def init_process_group_from_file(path: str, rank: int, world: int, *, backend: str,
                                 timeout_s: float = 120.0) -> None:
    """Start the default process group from a ``FileStore`` at ``path`` (no
    TCP port), with an explicit timeout so a deadlocked exchange fails.
    For launchers and tests; library calls never start a group."""
    store = dist.FileStore(path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


class Mesh:
    """A named device mesh as this rank sees it.

    Attributes:
        axis_names: the mesh's axis names, outermost first.
        shape: axis -> size (as a JAX mesh's ``shape``).
        size: devices in the mesh.
        rank: this rank's index in the mesh, row-major (0 on one rank).
        device: this rank's ``torch.device``.
        device_mesh: the ``DeviceMesh`` over the default group, or None for
            a one-device mesh without a process group.
        backend: the default group's backend, or None without a group.
    """

    def __init__(self, shape, axis_names, *, device=None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} disagree")
        n, world = math.prod(shape), world_size()
        if not 1 <= n <= world:
            raise ValueError(f"bad mesh size: a mesh of {n} device(s) needs "
                             f"1 <= n <= the {world} available")
        if 1 < n < world:
            raise ValueError(
                f"bad mesh size: a mesh of {n} devices spans {n} of the {world} "
                "ranks — a multi-rank mesh spans every rank of the default "
                "process group, or one"
            )
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape, strict=True))
        self.size = n
        self.device = rank_device(device)
        self.device_mesh = None
        self.backend = None
        self.rank = 0
        if n == world and dist.is_available() and dist.is_initialized():
            from torch.distributed.device_mesh import init_device_mesh

            self.backend = dist.get_backend()
            if self.backend == "nccl" and self.device.type != "cuda":
                raise ValueError("an NCCL mesh needs its rank on the card")
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self.device_mesh = init_device_mesh(
                "cuda" if self.backend == "nccl" else "cpu", shape,
                mesh_dim_names=axis_names)
            self.rank = dist.get_rank()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")

    # ------------------------------------------------------------------
    # Place
    # ------------------------------------------------------------------

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        stride = math.prod(self.shape[a] for a in self.axis_names[self.axis_names.index(axis) + 1:])
        return (self.rank // stride) % self.shape[axis]

    def index(self, axes) -> tuple[int, int]:
        """(this rank's index, the count) over ``axes`` flattened in mesh
        order: the slice a dimension sharded over ``axes`` gives it."""
        axes = [a for a in self.axis_names if a in tuple(axes)]
        idx, count = 0, 1
        for a in axes:
            idx = idx * self.shape[a] + self.coordinate(a)
            count *= self.shape[a]
        return idx, count

    # ------------------------------------------------------------------
    # Collectives (identity without a process group)
    # ------------------------------------------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def gather_axis(self, t: torch.Tensor, axis: str) -> list[torch.Tensor]:
        """Every rank's ``t`` along ``axis``, in rank order along it (equal
        shapes everywhere)."""
        if self.device_mesh is None or self.shape[axis] == 1:
            return [t]
        group = self.device_mesh.get_group(axis)
        src = t.contiguous()
        staged = self._staged(src)
        if staged:
            src = self._host(src)
        out = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(out, src, group=group)
        if staged:
            out = [o.to(t.device) for o in out]
        return out

    def gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """``t`` concatenated along ``dim`` over ``axes``, one axis after the
        other (the reference's tiled ``all_gather`` per axis)."""
        for ax in axes:
            parts = self.gather_axis(t, ax)
            t = parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
        return t

    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``t`` over ``axes``: per axis an ``all_gather`` and a
        sum in rank order along it."""
        for ax in axes:
            parts = self.gather_axis(t, ax)
            if len(parts) > 1:
                t = parts[0].clone()
                for p in parts[1:]:
                    t += p
        return t

    def exchange(self, t: torch.Tensor, peer: int) -> torch.Tensor:
        """Send ``t`` to mesh rank ``peer`` and receive its tensor of the same
        shape (one ``batch_isend_irecv`` pair)."""
        if self.device_mesh is None:
            raise ValueError("exchange needs a multi-rank mesh")
        src = t.contiguous()
        staged = self._staged(src)
        if staged:
            src = self._host(src)
        recv = torch.empty_like(src)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, peer),
                                       dist.P2POp(dist.irecv, recv, peer)])
        for r in reqs:
            r.wait()
        return recv.to(t.device) if staged else recv

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a one-element gather)."""
        if self.device_mesh is not None:
            self.gather(torch.zeros(1, device=self.device), self.axis_names, 0)


def part(mesh, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """This rank's part of ``t`` along ``dim`` split over ``axes`` (a view):
    part ``i`` of ``n`` with (i, n) = ``mesh.index(axes)``, the axes
    flattened in mesh order, the first outermost."""
    i, n = mesh.index(axes)
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def gather_parts(mesh, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """Every rank's ``t`` along ``dim`` over ``axes``, in the order
    :func:`part` cuts: one ``gather_axis`` an axis, the innermost first."""
    for ax in reversed([a for a in mesh.axis_names if a in tuple(axes)]):
        parts = mesh.gather_axis(t, ax)
        t = parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
    return t


def rank_backend(device) -> str:
    """NCCL for ranks on the card (``None`` or a CUDA device), gloo for
    ranks on the host."""
    on_card = device is None or torch.device(device).type == "cuda"
    return "nccl" if on_card else "gloo"


def spawn_ranks(module: str, argv: list, world: int, rank_args) -> None:
    """Run ``python -m module *argv *rank_args(r, store)`` once per rank
    (``LOCAL_RANK=r``; the ranks share the ``FileStore`` file ``store`` in a
    temporary directory), wait for all, and print rank 0's output.

    Raises:
        SystemExit: a rank failed (its exit code and the end of its
            standard error).
    """
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen([sys.executable, "-m", module, *argv, *rank_args(r, store)],
                                  env=dict(env, LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(world)]
        outs = [p.communicate() for p in procs]
    print(outs[0][0], end="")
    for r, (p, (_, err)) in enumerate(zip(procs, outs, strict=True)):
        if p.returncode:
            raise SystemExit(f"error: rank {r} of {world} failed:\n{err[-3000:]}")


def make_host_mesh(model_parallel: int = 1, *, device=None) -> Mesh:
    """A ("data", "model") mesh over every rank (CPU demos, tests)."""
    n = world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not divide into model_parallel={model_parallel}")
    return Mesh((n // model_parallel, model_parallel), ("data", "model"), device=device)


def make_tenant_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """1-D mesh named 'tenants' for sharded DAEF fleets (core/fleet_sharded):
    K tenant models split K/D per rank.  Defaults to every rank."""
    from repro_torch.core import fleet_sharded

    return fleet_sharded.tenant_mesh(n_devices, device=device)


def data_axes(mesh) -> tuple[str, ...]:
    """The batch-sharding axes of a mesh (('pod', 'data') when multi-pod)."""
    return tuple(a for a in mesh.axis_names if a in DATA_AXIS_NAMES)
