"""One rank of the port's LM-mesh cases (tests/test_torch_lm_mesh.py), run
as its own process:

    python tests/_torch_lm_mesh_ranks.py RANK WORLD STORE_FILE IN_DIR OUT_DIR [GROUP]

The ranks start a gloo group from a ``FileStore`` (no TCP port), read the
cases' inputs from ``IN_DIR/inputs.npz`` (written by the test from the
reference's parameters and seeded numpy draws), run every case on the CPU
through the port's public entry points under ``hints.use_mesh``, and each
writes what it holds to ``OUT_DIR/rank{RANK}.npz``: the differentiable
collectives' outputs and input gradients, the attention blocks' outputs and
gathered gradients, and the train steps' losses and gathered parameters and
Adam moments.  With two ranks only the collectives run.  With GROUP
(tests/test_torch_lm_mesh_{vlm_moe,recurrent,encdec}.py) only the family
cases of that group whose mesh spans WORLD ranks run: the MoE dispatch
masks of a forward, then one train step each.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_lm_mesh_cases as cases  # noqa: E402

from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import shardings, steps  # noqa: E402
from repro_torch.models import attention, get_bundle, hints, moe  # noqa: E402


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def collectives(out: dict, inputs: dict, world: int) -> None:
    """Each Function on every mesh of ``cases.collective_meshes(world)``:
    the output and the input's gradient of ``cases.collective_loss``."""
    for name, (shape, axes) in cases.collective_meshes(world).items():
        mesh = mesh_lib.Mesh(shape, axes, device="cpu")
        for axis in axes:
            n = mesh.shape[axis]
            i = mesh.coordinate(axis)
            for fn in cases.FUNCTIONS:
                x_all = torch.from_numpy(inputs[f"coll/{name}/{axis}/{fn}/x"])
                w_all = torch.from_numpy(inputs[f"coll/{name}/{axis}/{fn}/w"])
                x = (x_all[i] if fn in cases.PER_RANK_INPUT else x_all).clone()
                x.requires_grad_(True)
                y = cases.apply(fn, x, mesh, axis, n)
                loss = (y * cases.weight_for(fn, w_all, i, n, y)).sum()
                (g,) = torch.autograd.grad(loss, x)
                out[f"coll/{name}/{axis}/{fn}/y"] = _np(y)
                out[f"coll/{name}/{axis}/{fn}/g"] = _np(g)


def attention_blocks(out: dict, inputs: dict) -> None:
    """The attention block on a ("data", "model") = (1, 4) mesh, both routes:
    the output, the gradient of x and the gathered gradient of every
    parameter under ``sum(out * w)``."""
    mesh = mesh_lib.Mesh((1, cases.D), ("data", "model"), device="cpu")
    base = registry.get("qwen3-1.7b").reduced()
    for name, (h, hkv) in cases.ATTN_HEADS.items():
        cfg = cases.attn_cfg(base, h, hkv)
        full = {k: torch.from_numpy(v) for k, v in
                cases.flatten(cases.unflatten(inputs, f"attn/{name}/p/")).items()}
        x = torch.from_numpy(inputs[f"attn/{name}/x"]).requires_grad_(True)
        w = torch.from_numpy(inputs[f"attn/{name}/w"])
        with hints.use_mesh(mesh):
            tree = cases.unflatten(full, "")
            specs = shardings.param_shardings(tree, mesh)
            p = shardings.shard_tree(tree, specs, mesh)
            leaves = list(cases.flatten(p).values())
            for t in leaves:
                t.requires_grad_(True)
            y, _ = attention.attention_block(p, cfg, x)
            grads = torch.autograd.grad((y * w).sum(), [x, *leaves])
            g_tree = cases.unflatten(dict(zip(cases.flatten(p), grads[1:], strict=True)), "")
            full_grads = cases.flatten(shardings.gather_tree(g_tree, specs, mesh))
        out[f"attn/{name}/y"] = _np(y)
        out[f"attn/{name}/dx"] = _np(grads[0])
        for k, g in full_grads.items():
            out[f"attn/{name}/dp/{k}"] = _np(g)


def train_steps(out: dict, inputs: dict) -> None:
    """One AdamW step of each ``cases.TRAIN`` model on its mesh, from the
    reference's parameters: the loss and every gathered parameter and Adam
    moment."""
    for name, case in cases.TRAIN.items():
        cfg = registry.get(case["arch"]).reduced()
        mesh = mesh_lib.Mesh(case["mesh"], ("data", "model"), device="cpu")
        full = interop.lm_params_from_numpy(cfg, cases.unflatten(inputs, f"train/{name}/p/"),
                                            device="cpu")
        tokens = torch.from_numpy(inputs[f"train/{name}/tokens"])
        shardings.FSDP_MIN_ELEMENTS = cases.FSDP_MIN_ELEMENTS
        with hints.use_mesh(mesh):
            specs = shardings.lm_param_specs(cfg, mesh)
            params = shardings.shard_tree(full, specs, mesh)
            batch = shardings.shard_tree({"tokens": tokens},
                                         shardings.batch_shardings({"tokens": tokens}, mesh),
                                         mesh)
            opt = cases.optimizer(optim)
            state = opt.init(params)
            step = steps.make_train_step(get_bundle(cfg), opt, microbatches=case["micro"],
                                         clip_norm=1.0)
            params, state, loss = step(params, state, batch)
            got = {"params": params, "mu": state.mu, "nu": state.nu}
            got = {k: shardings.gather_tree(v, specs, mesh) for k, v in got.items()}
        out[f"train/{name}/loss"] = _np(loss)
        out[f"train/{name}/specs"] = np.array(repr(sorted(cases.flatten(specs).items())))
        for k, tree in got.items():
            for path, leaf in cases.flatten(tree).items():
                out[f"train/{name}/{k}/{path}"] = _np(leaf)


def dispatches(bundle, params, tokens) -> list:
    """Each MoE layer's dispatch mask in a no-grad forward of this rank's
    rows (every rank routes alike, before taking its experts' columns)."""
    calls = []
    route = moe.route

    def logged(logits, top_k, cap):
        got = route(logits, top_k, cap)
        calls.append(_np(got[0]))
        return got

    moe.route = logged
    try:
        bundle.forward(params, tokens)
    finally:
        moe.route = route
    return calls


def family_steps(out: dict, inputs: dict, world: int, group: str) -> None:
    """One AdamW step of each ``cases.family_cases(group, world)`` model on
    its mesh, from the reference's parameters: the MoE dispatch masks of a
    forward first, then the loss and every gathered parameter and Adam
    moment."""
    shardings.FSDP_MIN_ELEMENTS = cases.FSDP_MIN_ELEMENTS
    for name, case in cases.family_cases(group, world).items():
        cfg = cases.family_cfg(registry, case)
        mesh = mesh_lib.Mesh(case["mesh"], ("data", "model"), device="cpu")
        full = interop.lm_params_from_numpy(
            cfg, cases.family_params(inputs, f"fam/{name}/p/", cfg), device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in
                 cases.unflatten(inputs, f"fam/{name}/batch/").items()}
        bundle = get_bundle(cfg)
        with hints.use_mesh(mesh):
            specs = shardings.lm_param_specs(cfg, mesh)
            params = shardings.shard_tree(full, specs, mesh)
            batch = shardings.shard_tree(batch, shardings.batch_shardings(batch, mesh), mesh)
            if cfg.family == "moe":
                for i, d in enumerate(dispatches(bundle, params, batch["tokens"])):
                    out[f"fam/{name}/dispatch/{i}"] = d
            opt = cases.optimizer(optim)
            state = opt.init(params)
            step = steps.make_train_step(bundle, opt, microbatches=case["micro"], clip_norm=1.0)
            params, state, loss = step(params, state, batch)
            got = {"params": params, "mu": state.mu, "nu": state.nu}
            got = {k: shardings.gather_tree(v, specs, mesh) for k, v in got.items()}
        out[f"fam/{name}/loss"] = _np(loss)
        out[f"fam/{name}/specs"] = np.array(repr(sorted(cases.flatten(specs).items())))
        for k, tree in got.items():
            for path, leaf in cases.flatten(tree).items():
                out[f"fam/{name}/{k}/{path}"] = _np(leaf)


def main(rank: int, world: int, store: str, in_dir: str, out_dir: str,
         group: str | None = None) -> None:
    torch.set_num_threads(1)
    mesh_lib.init_process_group_from_file(store, rank, world, backend="gloo", timeout_s=120)
    inputs = dict(np.load(os.path.join(in_dir, "inputs.npz")))
    out: dict = {}
    try:
        if group is not None:
            family_steps(out, inputs, world, group)
        else:
            collectives(out, inputs, world)
            if world == cases.D:
                attention_blocks(out, inputs)
                train_steps(out, inputs)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{world}_{rank}.npz"), **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
         *sys.argv[6:7])
