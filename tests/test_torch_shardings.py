"""The port's sharding rules (``launch/shardings.py``) and hints
(``models/hints.py``) against the JAX package's, on the CPU.

The reference's rules read only a mesh's ``axis_names`` and ``shape``, so
a ``jax.sharding.AbstractMesh`` runs them here, in process, on
``jax.eval_shape`` trees at full width, with no devices; the port's rules
take the same mesh object and the port's own parameter tree as meta
tensors (``bundle.init(0, device="meta")``).  Held entry for entry, for
every registered arch, full and reduced, on the meshes (data, model) =
(2, 2), (1, 4), (4, 1) and (pod, data, model) = (2, 2, 2): the parameters'
specs (at the default ``FSDP_MIN_ELEMENTS``, where the full-width layer
stacks take FSDP), the AdamW state's, the inputs' of ``train_4k`` and the
decode caches' of a batch of 128 at 4,096 tokens.

``shard_tree`` then ``gather_tree`` returns every leaf unchanged: here with
the mesh's ranks as threads trading slices through a shared board
(tests/test_torch_lm_mesh.py runs them over gloo ranks).
"""
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_parity import assert_close

from repro import optim as joptim
from repro.configs import registry as jregistry
from repro.launch import shardings as jshardings
from repro.models import api as japi
from repro.models import get_bundle as jget_bundle
from repro.models import hints as jhints
from repro_torch import optim
from repro_torch.configs import registry
from repro_torch.launch import shardings
from repro_torch.models import api, get_bundle, hints
from repro_torch.train import checkpoint

MESHES = {
    "data2-model2": ((2, 2), ("data", "model")),
    "data1-model4": ((1, 4), ("data", "model")),
    "data4-model1": ((4, 1), ("data", "model")),
    "pod2-data2-model2": ((2, 2, 2), ("pod", "data", "model")),
}
CASES = [(arch, reduced) for arch in sorted(registry.ARCHS) for reduced in (False, True)]
DECODE_BATCH, DECODE_SEQ = 128, 4_096


def _mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _key(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def _ref_specs(tree) -> dict:
    """{path: spec entries} of a tree of ``NamedSharding``s."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {"/".join(_key(e) for e in path): tuple(s.spec) for path, s in leaves}


def _port_specs(specs, tree) -> dict:
    """{path: spec} of the port's ``specs`` for the leaves of ``tree`` (the
    specs are tuples, so the tree of data tells leaves from containers)."""
    out = {}

    def record(path, _):
        spec = specs
        for key in path:
            spec = getattr(spec, key) if isinstance(key, str) and hasattr(spec, "_fields") \
                else spec[key]
        out["/".join(str(p) for p in path)] = spec

    shardings.map_with_path(record, tree)
    return out


def _configs(arch, reduced):
    jcfg, cfg = jregistry.get(arch), registry.get(arch)
    return (jcfg.reduced(), cfg.reduced()) if reduced else (jcfg, cfg)


@functools.lru_cache(maxsize=None)
def _shapes(arch, reduced):
    """(the reference's parameter and AdamW state shapes, the port's as meta
    tensors)."""
    jcfg, cfg = _configs(arch, reduced)
    jparams = jax.eval_shape(jget_bundle(jcfg).init, jax.random.PRNGKey(0))
    jstate = jax.eval_shape(joptim.adamw(1e-4).init, jparams)
    params = get_bundle(cfg).init(0, device="meta")
    return jparams, jstate, params, optim.adamw(1e-4).init(params)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,reduced", CASES,
                         ids=[f"{a}-{'reduced' if r else 'full'}" for a, r in CASES])
def test_param_and_optimizer_specs_match_reference(arch, reduced, mesh_name):
    mesh = _mesh(mesh_name)
    jparams, jstate, params, state = _shapes(arch, reduced)
    jspecs = jshardings.param_shardings(jparams, mesh)
    specs = shardings.param_shardings(params, mesh)
    want, got = _ref_specs(jspecs), _port_specs(specs, params)
    assert got == want
    # the leaf shapes the rules read are the reference's
    jshape = {"/".join(_key(e) for e in p): tuple(x.shape)
              for p, x in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    shapes = {}
    shardings.map_with_path(lambda path, x: shapes.__setitem__(
        "/".join(str(p) for p in path), tuple(x.shape)), params)
    assert shapes == jshape
    j_opt = jshardings.opt_state_shardings(jstate, jspecs, mesh)
    opt = shardings.opt_state_shardings(state, specs, mesh)
    assert tuple(j_opt.step.spec) == opt.step == ()
    for field in ("mu", "nu"):
        assert _port_specs(getattr(opt, field), params) == _ref_specs(getattr(j_opt, field))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,reduced", CASES,
                         ids=[f"{a}-{'reduced' if r else 'full'}" for a, r in CASES])
def test_batch_and_cache_specs_match_reference(arch, reduced, mesh_name):
    mesh = _mesh(mesh_name)
    jcfg, cfg = _configs(arch, reduced)
    shape = registry.SHAPES["train_4k"]
    jbatch = jget_bundle(jcfg).input_specs(jregistry.SHAPES["train_4k"], jnp.bfloat16)
    batch = get_bundle(cfg).input_specs(shape, torch.bfloat16)
    assert _port_specs(shardings.batch_shardings(batch, mesh), batch) == _ref_specs(
        jshardings.batch_shardings(jbatch, mesh))
    jcache = japi.cache_specs(jget_bundle(jcfg), DECODE_BATCH, DECODE_SEQ, jnp.bfloat16)
    cache = api.cache_specs(get_bundle(cfg), DECODE_BATCH, DECODE_SEQ, torch.bfloat16)
    want = _ref_specs(jshardings.cache_shardings(jcache, jcfg, mesh))
    got = list(_port_specs(shardings.cache_shardings(cache, cfg, mesh), cache).values())
    assert got == list(want.values()) and len(got) > 0


def test_fsdp_threshold_is_read_at_each_call(monkeypatch):
    """Tests lower ``FSDP_MIN_ELEMENTS`` (the LM-mesh cases do, in their own
    processes); the rules read it at each call, as the reference's do."""
    mesh = _mesh("data2-model2")
    leaf = torch.empty((2, 64, 128), device="meta")
    assert shardings.param_spec(("layers", "mlp", "w_up"), leaf, mesh) == (None, None, "model")
    monkeypatch.setattr(shardings, "FSDP_MIN_ELEMENTS", 1 << 12)
    assert shardings.param_spec(("layers", "mlp", "w_up"), leaf, mesh) == (None, "data", "model")


class _ThreadMesh:
    """Rank ``rank`` of a mesh whose ranks are threads of this process:
    ``gather_axis`` trades tensors with the peers along an axis through a
    shared board and a barrier per group of peers, and ``psum`` sums them
    (``hints.use_mesh`` is per thread)."""

    def __init__(self, shape, axes, rank, board):
        self.axis_names, self.shape = axes, dict(zip(axes, shape, strict=True))
        self.rank, self.board, self.size = rank, board, int(np.prod(shape))

    def _stride(self, axis):
        return int(np.prod([self.shape[a] for a in
                            self.axis_names[self.axis_names.index(axis) + 1:]]))

    def coordinate(self, axis):
        return (self.rank // self._stride(axis)) % self.shape[axis]

    def index(self, axes):
        axes = [a for a in self.axis_names if a in tuple(axes)]
        idx, count = 0, 1
        for a in axes:
            idx, count = idx * self.shape[a] + self.coordinate(a), count * self.shape[a]
        return idx, count

    def gather_axis(self, t, axis):
        n = self.shape[axis]
        if n == 1:
            return [t]
        group = (axis, self.rank - self.coordinate(axis) * self._stride(axis))
        with self.board["lock"]:
            slots, barrier = self.board.setdefault(group, ({}, threading.Barrier(n)))
        slots[self.coordinate(axis)] = t
        barrier.wait()
        parts = [slots[i] for i in range(n)]
        barrier.wait()  # every peer has read the board before it is reused
        return parts

    def psum(self, t, axes):
        """The sum over ``axes`` in rank order (``Mesh.psum``'s)."""
        for ax in axes:
            parts = self.gather_axis(t, ax)
            t = parts[0].clone() if len(parts) > 1 else t
            for p in parts[1:]:
                t += p
        return t


@pytest.mark.parametrize("mesh_name", ["data2-model2", "pod2-data2-model2"])
def test_shard_then_gather_returns_every_leaf(mesh_name):
    """``shard_tree`` then ``gather_tree`` on every rank of the mesh (the
    ranks as threads) gives every rank every leaf unchanged: the reduced
    qwen3's parameters under the rules with FSDP lowered so it engages, and
    leaves split over two axes on one dim."""
    shape, axes = MESHES[mesh_name]
    cfg = registry.get("qwen3-1.7b").reduced()
    params = get_bundle(cfg).init(0, device="cpu")
    params["extra"] = {"two_axes": torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)}
    board = {"lock": threading.Lock()}
    size = int(np.prod(shape))
    results = [None] * size

    def rank(r):
        mesh = _ThreadMesh(shape, axes, r, board)
        specs = shardings.param_shardings(params, mesh)
        specs["extra"]["two_axes"] = (tuple(a for a in axes if a != "model"), "model")
        local = shardings.shard_tree(params, specs, mesh)
        results[r] = (local, shardings.gather_tree(local, specs, mesh))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shardings, "FSDP_MIN_ELEMENTS", 1 << 14)
        threads = [threading.Thread(target=rank, args=(r,)) for r in range(size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    flat = checkpoint.flatten(params)
    assert any(l.numel() < f.numel() for l, f in
               zip(checkpoint.flatten(results[0][0]), flat, strict=True))
    for _, gathered in results:
        for got, want in zip(checkpoint.flatten(gathered), flat, strict=True):
            assert torch.equal(got, want)


def test_hints_without_a_mesh_and_axis_helpers_match_reference():
    x = torch.ones(4, 6)
    assert hints.active_mesh() is None
    assert hints.hint(x, {0: "data", 1: "model"}) is x
    with hints.use_mesh(None):
        assert hints.active_mesh() is None and hints.hint(x, {0: "model"}) is x
    for name in MESHES:
        mesh = _mesh(name)
        for axis in ("data", "model", ("pod", "data"), ("data", "model"), "tenants"):
            assert hints.axis_extent(mesh, axis) == jhints.axis_extent(mesh, axis)
        for cands in (((3, 2), (4, 6)), ((3, 3), (4, 8)), ((1, 5),), ()):
            assert hints.pick_divisible(mesh, "model", *cands) == jhints.pick_divisible(
                mesh, "model", *cands)


def _check_on_thread_mesh(cfg, model: int):
    """Under a (data, model) = (1, ``model``) mesh whose ranks are threads:
    ``init`` gives each rank its slices of the one-process parameters
    (gathered back bit for bit), and ``forward``, ``prefill``, ``loss`` and
    every gathered gradient leaf (the backward run on another thread, as
    the autograd engine's device thread runs it on the card, so the
    rematerialised layers must find their mesh again) match one
    process's."""
    bundle = get_bundle(cfg)
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))}
    frontend = {"vlm": ("patch_embeds", (cfg.n_patches, cfg.d_frontend)),
                "encdec": ("frames", (cfg.encoder_seq, cfg.d_model))}.get(cfg.family)
    if frontend:
        batch[frontend[0]] = torch.from_numpy(
            rng.normal(size=(2, *frontend[1])).astype(np.float32))
    full = bundle.init(0, device="cpu")
    want = (bundle.forward(full, *(batch[k] for k in batch)), bundle.prefill(full, batch))
    flat = checkpoint.flatten(full)
    for t in flat:
        t.requires_grad_(True)
    want_loss = bundle.loss(full, batch)
    want_grads = torch.autograd.grad(want_loss, flat)
    board = {"lock": threading.Lock()}
    results = [None] * model

    def rank(r):
        mesh = _ThreadMesh((1, model), ("data", "model"), r, board)
        specs = shardings.lm_param_specs(cfg, mesh)
        with hints.use_mesh(mesh):
            local = bundle.init(0, device="cpu")
            gathered = shardings.gather_tree(local, specs, mesh)
            got = [bundle.forward(local, *(batch[k] for k in batch)),
                   bundle.prefill(local, batch)]
            mine = checkpoint.flatten(local)
            for t in mine:
                t.requires_grad_(True)
            loss = bundle.loss(local, batch)
        grads = []
        backward = threading.Thread(
            target=lambda: grads.extend(torch.autograd.grad(loss, mine)))
        backward.start()
        backward.join(timeout=120)
        full_grads = shardings.gather_tree(checkpoint.unflatten(local, grads), specs, mesh)
        results[r] = (mine, gathered, got, loss.detach(), checkpoint.flatten(full_grads))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(model)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert all(results), "a rank thread failed"
    for local, gathered, got, loss, grads in results:
        assert any(l.numel() < f.numel() for l, f in zip(local, flat, strict=True))
        for g, f in zip(checkpoint.flatten(gathered), flat, strict=True):
            assert torch.equal(g, f)
        for g, w, what in zip(got, want, ("forward", "prefill"), strict=True):
            assert_close(g, w, what=f"{cfg.name} {what}")
        assert_close(loss, want_loss.detach(), what=f"{cfg.name} loss")
        for i, (g, w) in enumerate(zip(grads, want_grads, strict=True)):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()),
                                       msg=f"{cfg.name} gradient leaf {i}")


@pytest.mark.parametrize("arch", ["internvl2-2b", "qwen2-moe-a2.7b", "deepseek-v2-236b",
                                  "mamba2-780m", "recurrentgemma-9b", "whisper-tiny"])
def test_other_families_on_a_mesh_name_their_item(arch):
    """Every family's layout is ported (item 12): each runs on a (data,
    model) = (1, 2) mesh of threads as in one process
    (``_check_on_thread_mesh``; tests/test_torch_lm_mesh_*.py hold train
    steps over gloo ranks against the reference)."""
    _check_on_thread_mesh(registry.get(arch).reduced(), 2)


@pytest.mark.parametrize("arch,changes,model", [
    ("deepseek-v2-236b", {}, 3),
    ("mamba2-780m", {"ssm_head_dim": 512}, 2),
    ("qwen2-moe-a2.7b", {"n_experts": 3, "d_ff_expert": 96}, 3),
], ids=["mla-4-heads-over-3", "mamba2-1-head-over-2", "moe-3-experts-over-3"])
def test_layouts_whose_heads_do_not_split(arch, changes, model):
    """The routes for splits the heads or experts do not follow: MLA's 4
    heads over 3 ranks (each split weight gathered whole, the block run
    alike), mamba2's one head of 512 over 2 (the block alike up to the
    gated output, then the rank's channels through its rows of
    ``out_proj``), and 3 experts over 3 ranks (expert-parallel, one expert
    a rank, on a mesh of three)."""
    cfg = dataclasses.replace(registry.get(arch).reduced(), **changes)
    _check_on_thread_mesh(cfg, model)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-780m", "recurrentgemma-9b"])
def test_decode_under_a_model_axis_keeps_its_one_device_path(arch):
    """``bundle.decode`` under a mesh with a model axis raises before it
    reads a parameter: the parameters there are a rank's slices, and decode
    keeps its one-device path (the recurrent families' decode has no
    attention block to refuse it)."""
    bundle = get_bundle(registry.get(arch).reduced())
    mesh = _ThreadMesh((1, 2), ("data", "model"), 0, {"lock": threading.Lock()})
    with hints.use_mesh(mesh), pytest.raises(NotImplementedError, match="one-device path"):
        bundle.decode({"embed": {"table": torch.zeros(4, 2)}}, None,
                      np.zeros((1, 1), np.int32), 0)
