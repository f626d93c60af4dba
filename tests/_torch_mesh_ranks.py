"""One rank of the port's four-rank mesh cases (tests/_torch_mesh_cases.py),
run by tests/test_torch_mesh_distributed.py as its own process:

    python tests/_torch_mesh_ranks.py RANK WORLD STORE_FILE OUT_DIR

The ranks start a gloo group from a ``FileStore`` (no TCP port), run every
case on the CPU through the port's public entry points, and each writes
what it holds to ``OUT_DIR/rank{RANK}.npz``: gathered fleets and scores,
replicated merge results, per-rank data-mesh models.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_mesh_cases as cases  # noqa: E402

from repro_torch.core import daef, fleet_sharded, sharded  # noqa: E402
from repro_torch.engine import DAEFEngine, ExecutionPlan  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _put(out: dict, prefix: str, tree) -> None:
    for i, leaf in enumerate(checkpoint.flatten(tree)):
        out[f"{prefix}/leaf{i}"] = _np(leaf)


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    mesh_lib.init_process_group_from_file(store, rank, world, backend="gloo", timeout_s=60)
    try:
        out = run(rank)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def run(rank: int) -> dict:
    out: dict = {}
    cfg = daef.DAEFConfig(**cases.KW)

    # tenant-sharded fit, scores and thresholds: each rank its K/D tenants
    xs, seeds, n_valid = cases.tenant_data()
    engine = DAEFEngine(cfg, ExecutionPlan(mode="mesh", tenants=cases.K), device="cpu")
    mesh = engine.mesh
    assert mesh.shape == {"tenants": cases.D} and mesh.rank == rank
    fl = engine.fit(xs, seeds=seeds)
    assert fl.size == cases.K // cases.D
    _put(out, "fit", fleet_sharded.gather_fleet(fl, mesh))
    out["fit/scores"] = _np(mesh.gather(engine.scores(fl, xs, n_valid=n_valid), ("tenants",), 0))
    out["fit/thr"] = _np(mesh.gather(engine.thresholds(fl), ("tenants",), 0))

    # fleet_merge_tree: a group inside a rank and one over every rank
    sites = cases.site_data()
    for method in cases.METHODS:
        mcfg = daef.DAEFConfig(**dict(cases.KW, method=method))
        tree = DAEFEngine(mcfg, ExecutionPlan(mode="mesh", tenants=cases.K, merge="tree"),
                          device="cpu")
        sfl = tree.fit(sites, seeds=np.ones(cases.K, np.int32))
        for group in cases.TREE_GROUPS:
            merged = tree.reduce(sfl, group)
            if group * cases.D <= cases.K:  # local rounds only: the result stays sharded
                merged = fleet_sharded.gather_fleet(merged, mesh)
            _put(out, f"tree/{method}/{group}", merged)
        if method == "gram":
            m = sfl.model
            enc = type(m.encoder_factors)(*(mesh.gather(a, ("tenants",), 0)
                                            for a in m.encoder_factors))
            knw = tuple(type(k)(*(mesh.gather(a, ("tenants",), 0) for a in k))
                        for k in m.layer_knowledge)
            _put(out, "state", fleet_sharded.merge_state_tree(
                mcfg, enc, knw, cases.STATE_MASK, mesh=fleet_sharded.tenant_mesh(device="cpu")))

    # the data-sharded fit: each rank one federated node
    x = cases.mesh_data()
    for name, (shape, axes) in cases.DATA_MESHES.items():
        dmesh = mesh_lib.Mesh(shape, axes, device="cpu")
        for method in cases.METHODS:
            dcfg = daef.DAEFConfig(**dict(cases.KW, method=method))
            eng = DAEFEngine(dcfg, ExecutionPlan(mode="mesh", mesh_axes=axes), mesh=dmesh)
            model = eng.fit(x)
            assert model.train_errors.shape == (cases.N_DATA // cases.D,)
            full = model._replace(train_errors=sharded.gather_samples(
                model.train_errors, dmesh, axes))
            _put(out, f"data/{name}/{method}", full)
            out[f"data/{name}/{method}/scores"] = _np(
                sharded.gather_samples(eng.scores(model, x), dmesh, axes))
            out[f"data/{name}/{method}/thr"] = _np(eng.thresholds(model))

    # meshes over some of the ranks: the others idle, their calls None
    idle = {}
    six = DAEFEngine(cfg, ExecutionPlan(mode="mesh", tenants=cases.K6, merge="tree"),
                     device="cpu")
    assert six.mesh.shape == {"tenants": 3} and six.mesh.member == (rank < 3)
    fl6 = six.fit(cases.six_tenant_data(), seeds=cases.SEEDS6)
    red6 = six.reduce(fl6, 2)
    idle["six"] = (fl6, red6, six.session().round([x[:, :40], x[:, 40:80]]))
    if not six.idle:
        assert fl6.size == 2 and red6.size == 1
        _put(out, "six/fit", fleet_sharded.gather_fleet(fl6, six.mesh))
        _put(out, "six/tree", fleet_sharded.gather_fleet(red6, six.mesh))
    for method in cases.METHODS:
        dcfg = daef.DAEFConfig(**dict(cases.KW, method=method))
        sub = DAEFEngine(dcfg, ExecutionPlan(mode="mesh", mesh_axes=("data",),
                                             mesh_devices=cases.SUB), device="cpu")
        assert sub.mesh.shape == {"data": cases.SUB} and sub.idle == (rank >= cases.SUB)
        model = sub.fit(x)
        idle[f"data/{method}"] = (model, sub.scores(model, x), sub.thresholds(model))
        if not sub.idle:
            assert model.train_errors.shape == (cases.N_DATA // cases.SUB,)
            _put(out, f"sub/data/{method}", model._replace(train_errors=sharded.gather_samples(
                model.train_errors, sub.mesh, ("data",))))
            out[f"sub/data/{method}/thr"] = _np(sub.thresholds(model))
    pair = DAEFEngine(cfg, ExecutionPlan(mode="mesh", tenants=cases.K, mesh_devices=cases.SUB,
                                         merge="tree"), device="cpu")
    sfl = pair.fit(sites, seeds=np.ones(cases.K, np.int32))
    merged = pair.reduce(sfl, cases.K)   # 4 tenants a rank: 2 local rounds, 1 cross
    model = pair.session().round([sites[i] for i in range(4)])
    idle["pair"] = (sfl, merged, model)
    if not pair.idle:
        _put(out, "pair/tree", merged)
        _put(out, "pair/round", model)
    out["idle"] = np.array([all(v is None for v in vals) for vals in idle.values()])
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
