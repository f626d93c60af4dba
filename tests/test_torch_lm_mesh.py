"""The port's 2-D (data, model) LM layout over gloo ranks on the CPU, against
the reference's same calls on four forced host devices and against the
port's one-process calls.

One launch each, per test module: four rank processes and two rank
processes (tests/_torch_lm_mesh_ranks.py, one interpreter each,
``OMP_NUM_THREADS=1``, a gloo group from a ``FileStore`` under
``tmp_path``, no TCP port), and the reference through
``tests/_mesh_harness.run_on_devices`` with ``n_devices=4`` under
``jax.jit``, all side by side; each writes an ``.npz``.  Every launch has
its own timeout, and nothing of ``torch.distributed`` runs in the pytest
process.  The inputs are the reference's parameters (``bundle.init`` of the
reduced configs, as numpy) and seeded numpy draws, written once by the
fixture.

Cases (tests/_torch_lm_mesh_cases.py):

* the differentiable collectives of ``models/hints.py`` (``psum``,
  ``copy``, ``all_gather``, ``take_shard`` and ``hint``) over each axis of
  a (2, 2) and a (1, 4) mesh of four ranks and a (1, 2) mesh of two: each
  rank's output and input gradient against one process's autograd of the
  whole program;
* the attention block's ``attend_auto`` routes at model 4
  (``tests/test_distributed.py``'s two strategies and the group route):
  6/3 heads, sequence-parallel through B7 with ``q_offset``; 8/4
  head-parallel; 8/2, head-parallel with the KV heads gathered; the
  output, the input's gradient and every gathered parameter gradient
  against the reference's ``attention_block(chunked=True)`` under the mesh
  and its ``jax.grad``, and against the port's block in one process;
* one AdamW train step of reduced qwen3-1.7b at data 2 x model 2 with two
  microbatches (head-parallel), and of reduced qwen2-1.5b at data 1 x model
  4 at S = 64 (its 2 KV heads and group of 2 do not divide 4: the
  sequence-parallel route), against the reference's sharded step
  (``jax.jit`` under ``compat.set_mesh``, ``param_shardings`` and
  ``batch_shardings``; ``chunked_attn=True`` for qwen2, which is what
  reaches ``attend_auto``) and the port's one-process step.
  ``FSDP_MIN_ELEMENTS`` is lowered to 2^16 in the rank processes and the
  reference's subprocess (never in this process), so FSDP engages on the
  reduced layer leaves; the specs must agree.

Tolerance: the loss at ``TOLS``; every gathered parameter, its update and
every Adam moment as tests/test_torch_training.py holds one-device steps
(|d| <= 1e-4·max|want| + 1e-4·|want|, the update plus one float32 rounding
of p + u on each side): the sums over ranks and over the sharded vocab
add the same float32 terms in other orders.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from _mesh_harness import ROOT, run_on_devices
from _torch_parity import EPS32, assert_close

import _torch_lm_mesh_cases as cases
from repro.configs import registry as jregistry
from repro.models import get_bundle as jget_bundle
from repro_torch import interop, optim
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import attention, get_bundle

TESTS = os.path.join(ROOT, "tests")
RANK_TIMEOUT_S = 240
REF_TIMEOUT_S = 300

_REFERENCE = """
import dataclasses
import sys
sys.path.insert(0, {tests!r})
import _torch_lm_mesh_cases as cases
from repro import optim
from repro.configs import registry
from repro.launch import shardings, steps
from repro.launch.mesh import make_host_mesh
from repro.models import attention, get_bundle

shardings.FSDP_MIN_ELEMENTS = cases.FSDP_MIN_ELEMENTS
inputs = dict(np.load({inputs!r}))
out = {{}}

mesh = make_host_mesh(model_parallel=cases.D)
base = registry.get("qwen3-1.7b").reduced()
for name, (h, hkv) in cases.ATTN_HEADS.items():
    cfg = cases.attn_cfg(base, h, hkv)
    p = jax.tree.map(jnp.asarray, cases.unflatten(inputs, f"attn/{{name}}/p/"))
    x, w = jnp.asarray(inputs[f"attn/{{name}}/x"]), jnp.asarray(inputs[f"attn/{{name}}/w"])

    def loss(p, x):
        y, _ = attention.attention_block(p, cfg, x, chunked=True)
        return (y * w).sum(), y

    with compat.set_mesh(mesh):
        (_, y), (dp, dx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(p, x)
    out[f"attn/{{name}}/y"] = np.asarray(y)
    out[f"attn/{{name}}/dx"] = np.asarray(dx)
    for k, g in cases.flatten(dp).items():
        out[f"attn/{{name}}/dp/{{k}}"] = np.asarray(g)

for name, case in cases.TRAIN.items():
    cfg = registry.get(case["arch"]).reduced()
    bundle = get_bundle(cfg, chunked_attn=True)
    params = jax.tree.map(jnp.asarray, cases.unflatten(inputs, f"train/{{name}}/p/"))
    batch = {{"tokens": jnp.asarray(inputs[f"train/{{name}}/tokens"])}}
    opt = cases.optimizer(optim)
    step = steps.make_train_step(bundle, opt, microbatches=case["micro"], clip_norm=1.0)
    mesh = make_host_mesh(model_parallel=case["mesh"][1])
    p_shard = shardings.param_shardings(params, mesh)
    params_d = jax.device_put(params, p_shard)
    batch_d = jax.device_put(batch, shardings.batch_shardings(batch, mesh))
    with compat.set_mesh(mesh):
        p2, s2, loss = jax.jit(step)(params_d, opt.init(params_d), batch_d)
    out[f"train/{{name}}/loss"] = np.asarray(loss)
    specs = jax.tree.map(lambda s: tuple(s.spec), p_shard)
    out[f"train/{{name}}/specs"] = np.array(repr(sorted(cases.flatten(specs).items())))
    for k, tree in (("params", p2), ("mu", s2.mu), ("nu", s2.nu)):
        for path, leaf in cases.flatten(tree).items():
            out[f"train/{{name}}/{{k}}/{{path}}"] = np.asarray(leaf)

np.savez({path!r}, **out)
print("REFERENCE OK")
"""


def _inputs(path) -> dict:
    """Every case's inputs, written to ``path``: the collectives' draws,
    the attention blocks' draws and the reduced models' reference
    parameters and tokens."""
    arrays = {}
    for world in (cases.D, 2):
        for name, (shape, axes) in cases.collective_meshes(world).items():
            for axis, n in zip(axes, shape, strict=True):
                for fn in cases.FUNCTIONS:
                    for k, v in cases.collective_inputs(name, axis, fn, n).items():
                        arrays[f"coll/{name}/{axis}/{fn}/{k}"] = v
    for i, (name, (h, hkv)) in enumerate(cases.ATTN_HEADS.items()):
        for k, v in cases.attn_inputs(h, hkv, seed=40 + i).items():
            arrays[f"attn/{name}/{k}"] = v
    for i, (name, case) in enumerate(cases.TRAIN.items()):
        jb = jget_bundle(jregistry.get(case["arch"]).reduced())
        params = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(i)))
        for k, v in cases.flatten(params).items():
            arrays[f"train/{name}/p/{k}"] = v
        b, s = case["batch"]
        rng = np.random.default_rng(50 + i)
        arrays[f"train/{name}/tokens"] = rng.integers(
            0, jb.cfg.vocab_size, size=(b, s)).astype(np.int32)
    np.savez(path, **arrays)
    return arrays


def _reference(inputs_path, path) -> None:
    script = _REFERENCE.format(tests=TESTS, inputs=str(inputs_path), path=str(path))
    assert "REFERENCE OK" in run_on_devices(script, n_devices=cases.D, timeout=REF_TIMEOUT_S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs, start the port's four and two ranks, run the
    reference beside them, and load every ``.npz``: (inputs, the
    reference's arrays, {world: each rank's arrays})."""
    out = tmp_path_factory.mktemp("lm_mesh_runs")
    inputs = _inputs(out / "inputs.npz")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(var, None)
    ranks = [
        (world, r, subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "_torch_lm_mesh_ranks.py"), str(r),
             str(world), str(out / f"store{world}"), str(out), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for world in (cases.D, 2) for r in range(world)
    ]
    try:
        with ThreadPoolExecutor(1) as pool:
            job = pool.submit(_reference, out / "inputs.npz", out / "ref.npz")
            job.result()
        for world, r, proc in ranks:
            _, err = proc.communicate(timeout=RANK_TIMEOUT_S)
            assert proc.returncode == 0, f"rank {r} of {world}:\n{err[-3000:]}"
    finally:
        for _, _, proc in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ref = dict(np.load(out / "ref.npz"))
    got = {world: [dict(np.load(out / f"rank{world}_{r}.npz")) for r in range(world)]
           for world in (cases.D, 2)}
    return inputs, ref, got


def _same_on_every_rank(ranks: list, prefix: str) -> None:
    keys = [k for k in ranks[0] if k.startswith(prefix)]
    assert keys, prefix
    for g in ranks[1:]:
        for key in keys:
            assert np.array_equal(g[key], ranks[0][key]), key


@pytest.mark.parametrize("fn", cases.FUNCTIONS)
@pytest.mark.parametrize("world", [cases.D, 2])
def test_collectives_match_one_process_autograd(runs, world, fn):
    inputs, _, got = runs
    for name, (shape, axes) in cases.collective_meshes(world).items():
        for axis, n in zip(axes, shape, strict=True):
            key = f"coll/{name}/{axis}/{fn}"
            ys, gs = cases.one_process(fn, inputs[key + "/x"], inputs[key + "/w"], n)
            for rank, arrays in enumerate(got[world]):
                # the rank's index along the axis: row-major over (data, model)
                i = rank // shape[1] if axis == "data" else rank % shape[1]
                assert_close(arrays[key + "/y"], ys[i], what=f"{key} rank {rank} output")
                assert_close(arrays[key + "/g"], gs[i], what=f"{key} rank {rank} gradient")


def _one_process_attention(inputs, name, h, hkv):
    cfg = cases.attn_cfg(registry.get("qwen3-1.7b").reduced(), h, hkv)
    flat = {k: torch.from_numpy(v).requires_grad_(True) for k, v in
            cases.flatten(cases.unflatten(inputs, f"attn/{name}/p/")).items()}
    x = torch.from_numpy(inputs[f"attn/{name}/x"]).requires_grad_(True)
    y, _ = attention.attention_block(cases.unflatten(flat, ""), cfg, x)
    grads = torch.autograd.grad((y * torch.from_numpy(inputs[f"attn/{name}/w"])).sum(),
                                [x, *flat.values()])
    return y, grads[0], dict(zip(flat, grads[1:], strict=True))


@pytest.mark.parametrize("name", list(cases.ATTN_HEADS))
def test_attention_routes_match_reference_and_one_process(runs, name):
    inputs, ref, got = runs
    ranks = got[cases.D]
    _same_on_every_rank(ranks, f"attn/{name}/")
    mine = ranks[0]
    y1, dx1, dp1 = _one_process_attention(inputs, name, *cases.ATTN_HEADS[name])
    for what in ("y", "dx"):
        key = f"attn/{name}/{what}"
        assert_close(mine[key], ref[key], what=f"{key} vs the reference")
        assert_close(mine[key], y1 if what == "y" else dx1, what=f"{key} vs one process")
    for k, g in dp1.items():
        key = f"attn/{name}/dp/{k}"
        _assert_leaf_close(mine[key], ref[key], f"{key} vs the reference")
        _assert_leaf_close(mine[key], g, f"{key} vs one process")


def _assert_leaf_close(got, want, what):
    """|d| <= 1e-4·max|want| + 1e-4·|want| (tests/test_torch_training.py's bar)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=what)


def _check_step(have: dict, want: dict, before: dict, what: str) -> None:
    for k, old in before.items():
        p_have, p_want = have[f"params/{k}"], want[f"params/{k}"]
        assert_close(p_have, p_want, what=f"{what} params/{k}")
        d_have, d_want = np.float64(p_have) - old, np.float64(p_want) - old
        bar = 1e-4 * np.abs(d_want).max() + 1e-4 * np.abs(d_want) + 2 * EPS32 * np.abs(old)
        assert np.all(np.abs(d_have - d_want) <= bar), f"{what} params/{k} update"
        for m in ("mu", "nu"):
            _assert_leaf_close(have[f"{m}/{k}"], want[f"{m}/{k}"], f"{what} {m}/{k}")


def _one_process_step(inputs, name, case) -> dict:
    cfg = registry.get(case["arch"]).reduced()
    params = interop.lm_params_from_numpy(
        cfg, cases.unflatten(inputs, f"train/{name}/p/"), device="cpu")
    opt = cases.optimizer(optim)
    state = opt.init(params)
    step = steps.make_train_step(get_bundle(cfg), opt, microbatches=case["micro"], clip_norm=1.0)
    params, state, loss = step(params, state,
                               {"tokens": torch.from_numpy(inputs[f"train/{name}/tokens"])})
    out = {"loss": loss.numpy()}
    for k, tree in (("params", params), ("mu", state.mu), ("nu", state.nu)):
        for path, leaf in cases.flatten(tree).items():
            out[f"{k}/{path}"] = leaf.detach().numpy()
    return out


@pytest.mark.parametrize("name", list(cases.TRAIN))
def test_train_step_matches_reference_and_one_process(runs, name):
    inputs, ref, got = runs
    ranks = got[cases.D]
    prefix = f"train/{name}/"
    _same_on_every_rank(ranks, prefix)
    mine = {k[len(prefix):]: v for k, v in ranks[0].items() if k.startswith(prefix)}
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    assert str(mine.pop("specs")) == str(want.pop("specs"))
    assert "'data'" in str(ranks[0][prefix + "specs"])  # FSDP engaged
    one = _one_process_step(inputs, name, cases.TRAIN[name])
    before = {k[len(prefix) + 2:]: v for k, v in inputs.items() if k.startswith(prefix + "p/")}
    assert_close(mine["loss"], want["loss"], what=f"{name} loss vs the reference")
    assert_close(mine["loss"], one["loss"], what=f"{name} loss vs one process")
    _check_step(mine, want, before, f"{name} vs the reference")
    _check_step(mine, one, before, f"{name} vs one process")
