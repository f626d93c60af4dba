"""The family train cases of the port's LM mesh (tests/test_torch_lm_mesh_
vlm_moe.py, _recurrent.py and _encdec.py): their launch and their checks.

Each test module runs one group of ``_torch_lm_mesh_cases.FAMILY_TRAIN``.
Per world (four ranks, and two for a (1, 2) mesh) the port's rank
processes (tests/_torch_lm_mesh_ranks.py with the group, one interpreter
each, ``OMP_NUM_THREADS=1``, a gloo group from a ``FileStore``, no TCP
port) and the reference on as many forced host devices
(``_mesh_harness.run_on_devices``) run side by side; each writes an
``.npz``.  Nothing of ``torch.distributed`` runs in the pytest process.
The inputs are random parameters of the case's reduced config (the port's
``bundle.init`` on the host, as numpy: the reference's eager init of five
configs took ~17 s) and seeded numpy batches; both packages take the same
arrays.

Each case is one AdamW step (clipped, two microbatches where the case
says) of the reference's ``make_train_step`` under ``jax.jit`` and
``compat.set_mesh`` on ``make_host_mesh(model)`` with ``param_shardings``
and ``batch_shardings`` (``chunked_attn=True``, which is what reaches
``attend_auto``), of the port's on its ranks, and of the port's in this
process (the one-process witness).  ``FSDP_MIN_ELEMENTS`` is lowered to
2^16 in the rank processes and the reference's subprocess (never in this
process), so FSDP engages on the reduced layer leaves at data 2; the
specs must agree.  For the MoE family the dispatch masks of a forward are
compared bit for bit first: every rank's (every rank routes alike), the
reference's (through ``jax.debug.callback`` under the mesh) and one
process's.

Tolerance: the loss within 1e-6 (``LOSS_TOL``); every gathered parameter,
its update and every Adam moment as tests/test_torch_training.py holds
one-device steps (|d| <= 1e-4·max|want| + 1e-4·|want|, the update plus
one float32 rounding of p + u on each side).
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from _mesh_harness import ROOT, run_on_devices
from _torch_parity import EPS32, assert_close

import _torch_lm_mesh_cases as cases
from repro_torch import interop, optim
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import get_bundle, moe

TESTS = os.path.join(ROOT, "tests")
# the loss within 1e-6 (a few float32 ulps at ln V ~ 6); measured <= 9.6e-7 apart
LOSS_TOL = dict(atol=1e-6, rtol=1e-6)
RANK_TIMEOUT_S = 240
REF_TIMEOUT_S = 300

_REFERENCE = """
import sys
sys.path.insert(0, {tests!r})
import _torch_lm_mesh_cases as cases
from repro import optim
from repro.configs import registry
from repro.launch import shardings, steps
from repro.launch.mesh import make_host_mesh
from repro.models import get_bundle, moe, moe_lm

shardings.FSDP_MIN_ELEMENTS = cases.FSDP_MIN_ELEMENTS
inputs = dict(np.load({inputs!r}))
out = {{}}
calls = []
route = moe.route


def logged(logits, top_k, cap):
    got = route(logits, top_k, cap)
    jax.debug.callback(lambda d: calls.append(np.asarray(d)), got[0])
    return got


for name, case in cases.family_cases({group!r}, {world}).items():
    cfg = cases.family_cfg(registry, case)
    bundle = get_bundle(cfg, chunked_attn=True)
    params = jax.tree.map(jnp.asarray, cases.family_params(inputs, f"fam/{{name}}/p/", cfg))
    batch = {{k: jnp.asarray(v) for k, v in
             cases.unflatten(inputs, f"fam/{{name}}/batch/").items()}}
    mesh = make_host_mesh(model_parallel=case["mesh"][1])
    assert tuple(mesh.devices.shape) == tuple(case["mesh"]), mesh
    p_shard = shardings.param_shardings(params, mesh)
    params_d = jax.device_put(params, p_shard)
    batch_d = jax.device_put(batch, shardings.batch_shardings(batch, mesh))
    if cfg.family == "moe":
        calls.clear()
        moe.route = logged
        with compat.set_mesh(mesh):
            jax.block_until_ready(jax.jit(
                lambda p, t: moe_lm.forward(p, cfg, t, chunked_attn=True, remat=False))(
                    params_d, batch_d["tokens"]))
        jax.effects_barrier()
        moe.route = route
        for i, d in enumerate(calls):
            out[f"fam/{{name}}/dispatch/{{i}}"] = d
    opt = cases.optimizer(optim)
    step = steps.make_train_step(bundle, opt, microbatches=case["micro"], clip_norm=1.0)
    with compat.set_mesh(mesh):
        p2, s2, loss = jax.jit(step)(params_d, opt.init(params_d), batch_d)
    out[f"fam/{{name}}/loss"] = np.asarray(loss)
    specs = jax.tree.map(lambda s: tuple(s.spec), p_shard)
    out[f"fam/{{name}}/specs"] = np.array(repr(sorted(cases.flatten(specs).items())))
    for k, tree in (("params", p2), ("mu", s2.mu), ("nu", s2.nu)):
        for path, leaf in cases.flatten(tree).items():
            out[f"fam/{{name}}/{{k}}/{{path}}"] = np.asarray(leaf)

np.savez({path!r}, **out)
print("REFERENCE OK")
"""


def worlds(group: str) -> list:
    """The rank counts the group's meshes span."""
    return sorted({int(np.prod(c["mesh"])) for c in cases.family_cases(group).values()},
                  reverse=True)


def _inputs(group: str, path) -> dict:
    """Every case's inputs, written to ``path``: random parameters of the
    case's reduced config and a seeded batch."""
    arrays = {}
    for i, (name, case) in enumerate(cases.family_cases(group).items()):
        cfg = cases.family_cfg(registry, case)
        for k, v in cases.flatten(get_bundle(cfg).init(i, device="cpu")).items():
            arrays[f"fam/{name}/p/{k}"] = v.numpy()
        for k, v in cases.family_batch(cfg, case, seed=60 + i).items():
            arrays[f"fam/{name}/batch/{k}"] = v
    np.savez(path, **arrays)
    return arrays


def _reference(group: str, world: int, inputs_path, path) -> None:
    script = _REFERENCE.format(tests=TESTS, inputs=str(inputs_path), path=str(path),
                               group=group, world=world)
    assert "REFERENCE OK" in run_on_devices(script, n_devices=world, timeout=REF_TIMEOUT_S)


def launch(group: str, out) -> tuple:
    """Write the group's inputs under ``out``, start the port's ranks of
    every world, run the reference beside them, and load every ``.npz``:
    (inputs, {world: the reference's arrays}, {world: each rank's arrays})."""
    inputs = _inputs(group, out / "inputs.npz")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(var, None)
    ranks = [
        (world, r, subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "_torch_lm_mesh_ranks.py"), str(r),
             str(world), str(out / f"store{world}"), str(out), str(out), group],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for world in worlds(group) for r in range(world)
    ]
    try:
        with ThreadPoolExecutor(len(worlds(group))) as pool:
            jobs = [pool.submit(_reference, group, world, out / "inputs.npz",
                                out / f"ref{world}.npz") for world in worlds(group)]
            for job in jobs:
                job.result()
        for world, r, proc in ranks:
            _, err = proc.communicate(timeout=RANK_TIMEOUT_S)
            assert proc.returncode == 0, f"rank {r} of {world}:\n{err[-3000:]}"
    finally:
        for _, _, proc in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ref = {world: dict(np.load(out / f"ref{world}.npz")) for world in worlds(group)}
    got = {world: [dict(np.load(out / f"rank{world}_{r}.npz")) for r in range(world)]
           for world in worlds(group)}
    return inputs, ref, got


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


def _one_process(inputs, name, case) -> dict:
    """The port's dispatch masks and train step of the case in this
    process."""
    cfg = cases.family_cfg(registry, case)
    params = interop.lm_params_from_numpy(
        cfg, cases.family_params(inputs, f"fam/{name}/p/", cfg), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             cases.unflatten(inputs, f"fam/{name}/batch/").items()}
    bundle = get_bundle(cfg)
    out = {}
    if cfg.family == "moe":
        calls, route = [], moe.route

        def logged(logits, top_k, cap):
            got = route(logits, top_k, cap)
            calls.append(got[0].numpy())
            return got

        moe.route = logged
        try:
            bundle.forward(params, batch["tokens"])
        finally:
            moe.route = route
        out.update({f"dispatch/{i}": d for i, d in enumerate(calls)})
    opt = cases.optimizer(optim)
    state = opt.init(params)
    step = steps.make_train_step(bundle, opt, microbatches=case["micro"], clip_norm=1.0)
    params, state, loss = step(params, state, batch)
    out["loss"] = loss.numpy()
    for k, tree in (("params", params), ("mu", state.mu), ("nu", state.nu)):
        for path, leaf in cases.flatten(tree).items():
            out[f"{k}/{path}"] = leaf.detach().numpy()
    return out


def _rank_dispatch(ranks: list, mesh: tuple, i: int) -> np.ndarray:
    """Layer ``i``'s dispatch over the whole batch: the data ranks' rows in
    order (each model rank routes its data rank's rows alike)."""
    data, model = mesh
    for r in range(len(ranks)):
        assert np.array_equal(ranks[r][f"dispatch/{i}"],
                              ranks[r - r % model][f"dispatch/{i}"]), f"rank {r} layer {i}"
    return np.concatenate([ranks[d * model][f"dispatch/{i}"] for d in range(data)])


def check_case(runs, name: str) -> None:
    """The case's MoE dispatch masks bit for bit, then its step against the
    reference's and the one-process witness's."""
    inputs, ref, got = runs
    case = cases.FAMILY_TRAIN[name]
    world = int(np.prod(case["mesh"]))
    prefix = f"fam/{name}/"
    ranks = [{k[len(prefix):]: v for k, v in r.items() if k.startswith(prefix)}
             for r in got[world]]
    want = {k[len(prefix):]: v for k, v in ref[world].items() if k.startswith(prefix)}
    one = _one_process(inputs, name, case)
    cfg = cases.family_cfg(registry, case)
    n_moe = cfg.n_layers - cfg.first_dense_layers if cfg.family == "moe" else 0
    for arrays in (one, want, ranks[0]):
        assert sum(k.startswith("dispatch/") for k in arrays) == n_moe
    for i in range(n_moe):
        d = _rank_dispatch(ranks, case["mesh"], i)
        np.testing.assert_array_equal(d, want[f"dispatch/{i}"], err_msg=f"{name} layer {i}")
        np.testing.assert_array_equal(d, one[f"dispatch/{i}"], err_msg=f"{name} layer {i}")
    steps_ = [{k: v for k, v in r.items() if not k.startswith("dispatch/")} for r in ranks]
    for r, arrays in enumerate(steps_[1:], 1):
        for k, v in arrays.items():
            assert np.array_equal(v, steps_[0][k]), f"rank {r} {k}"
    mine = dict(steps_[0])
    assert str(mine.pop("specs")) == str(want.pop("specs"))
    if case["mesh"][0] > 1:
        assert "'data'" in str(ranks[0]["specs"])  # FSDP engaged
    before = {k[len(prefix) + 2:]: v for k, v in inputs.items() if k.startswith(prefix + "p/")}
    for other, whose in ((want, "the reference"), (one, "one process")):
        assert_close(mine["loss"], other["loss"], what=f"{name} loss vs {whose}", **LOSS_TOL)
    _check_step(mine, want, before, f"{name} vs the reference")
    _check_step(mine, one, before, f"{name} vs one process")
