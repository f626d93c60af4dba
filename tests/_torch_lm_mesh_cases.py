"""The LM-mesh cases shared by tests/test_torch_lm_mesh.py, its rank
processes (tests/_torch_lm_mesh_ranks.py) and its reference subprocess:
meshes, shapes, seeds and the one-process answers of the differentiable
collectives.  Importing it imports numpy only.
"""
import dataclasses
import zlib

import numpy as np

D = 4                                   # ranks (and forced host devices)
FSDP_MIN_ELEMENTS = 1 << 16             # lowered so FSDP engages at reduced width
FUNCTIONS = ("psum", "copy", "all_gather", "take_shard", "hint")
PER_RANK_INPUT = {"psum", "all_gather"}  # each rank holds its own part of x
PIECE = 2                               # columns of a rank's part

# attention blocks on a (1, 4) mesh: (H, Hkv) -> the reference's attend_auto route
ATTN_HEADS = {"seq-parallel 6/3": (6, 3), "head-parallel 8/4": (8, 4),
              "group-parallel 8/2": (8, 2)}
ATTN_B, ATTN_S, ATTN_D_MODEL, ATTN_HD = 2, 256, 64, 32

TRAIN = {
    "qwen3 data 2 x model 2": dict(arch="qwen3-1.7b", mesh=(2, 2), micro=2, batch=(8, 32)),
    "qwen2 data 1 x model 4": dict(arch="qwen2-1.5b", mesh=(1, 4), micro=1, batch=(2, 64)),
}


def collective_meshes(world: int) -> dict:
    if world == 2:
        return {"1x2": ((1, 2), ("data", "model"))}
    return {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model"))}


def collective_inputs(name: str, axis: str, fn: str, n: int) -> dict:
    rng = np.random.default_rng(zlib.crc32(f"{name}/{axis}/{fn}".encode()))
    if fn == "psum":
        x, w = (n, 3, 5), (3, 5)
    elif fn == "copy":
        x, w = (3, 5), (n, 3, 5)
    elif fn == "all_gather":
        x, w = (n, 3, PIECE), (n, 3, PIECE * n)
    else:  # take_shard, hint
        x, w = (3, PIECE * n), (3, PIECE * n)
    return {"x": rng.normal(size=x).astype(np.float32),
            "w": rng.normal(size=w).astype(np.float32)}


def apply(fn: str, x, mesh, axis: str, n: int):
    """The SPMD side: rank's ``fn`` of its x."""
    from repro_torch.models import hints

    if fn == "psum":
        return hints.psum(x, mesh, axis)
    if fn == "copy":
        return hints.copy(x, mesh, axis)
    if fn == "all_gather":
        return hints.all_gather(x, mesh, 1, axis)
    if fn == "take_shard":
        return hints.take_shard(x, mesh, 1, axis)
    with hints.use_mesh(mesh):
        return hints.hint(x, {1: axis})


def weight_for(fn: str, w_all, i: int, n: int, y):
    """Rank i's weight in its loss sum(y * w).  The whole program's loss
    counts what every rank computes alike once (after ``psum``) and sums
    what the ranks compute apart (after the others)."""
    if fn == "psum":
        return w_all
    if fn in ("copy", "all_gather"):
        return w_all[i]
    return w_all[:, PIECE * i:PIECE * (i + 1)]


def one_process(fn: str, x_all, w_all, n: int):
    """(rank i's output, rank i's gradient) for every i, from one process's
    autograd of the whole program."""
    import torch

    x = torch.from_numpy(x_all).requires_grad_(True)
    w = torch.from_numpy(w_all)
    if fn == "psum":
        ys = [x.sum(0)] * n
    elif fn == "copy":
        ys = [x] * n
    elif fn == "all_gather":
        ys = [torch.cat(list(x), dim=1)] * n
    else:
        ys = [x[:, PIECE * i:PIECE * (i + 1)] for i in range(n)]
    if fn == "psum":
        loss = (ys[0] * w).sum()
    else:
        loss = sum((y * weight_for(fn, w, i, n, y)).sum() for i, y in enumerate(ys))
    (g,) = torch.autograd.grad(loss, x)
    grads = [g[i] if fn in PER_RANK_INPUT else g for i in range(n)]
    return [y.detach().numpy() for y in ys], [t.numpy() for t in grads]


def attn_cfg(base, h: int, hkv: int):
    """A dense config (port's or reference's ``ArchConfig``) with H / Hkv
    heads of 32, d_model 64, qk-norm and qkv bias."""
    return dataclasses.replace(base, n_heads=h, n_kv_heads=hkv, head_dim=ATTN_HD,
                               d_model=ATTN_D_MODEL, qk_norm=True, qkv_bias=True,
                               sliding_window=None)


def attn_inputs(h: int, hkv: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, hd = ATTN_D_MODEL, ATTN_HD

    def normal(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return {
        "x": normal(ATTN_B, ATTN_S, d),
        "w": normal(ATTN_B, ATTN_S, d),
        "p/wq": normal(d, h * hd, scale=d**-0.5), "p/wk": normal(d, hkv * hd, scale=d**-0.5),
        "p/wv": normal(d, hkv * hd, scale=d**-0.5), "p/wo": normal(h * hd, d, scale=0.1),
        "p/bq": normal(h * hd, scale=0.1), "p/bk": normal(hkv * hd, scale=0.1),
        "p/bv": normal(hkv * hd, scale=0.1),
        "p/q_norm/scale": 1 + normal(hd, scale=0.1), "p/k_norm/scale": 1 + normal(hd, scale=0.1),
    }


def optimizer(optim):
    """AdamW as tests/test_torch_training.py's step: eps = 1e-3 keeps each
    first update a smooth function of its gradient.  ``optim``: the port's
    or the reference's module."""
    return optim.adamw(optim.linear_warmup_cosine(1e-3, 2, 10), weight_decay=0.01, eps=1e-3)


def flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a tree of dicts (an empty list, the hybrid
    family's tail without blocks, has no leaf)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        elif not (isinstance(v, list) and not v):
            out[f"{prefix}{k}"] = v
    return out


def unflatten(arrays: dict, prefix: str) -> dict:
    """The tree of dicts under ``prefix`` of flat ``arrays``."""
    tree: dict = {}
    for key, value in arrays.items():
        if not key.startswith(prefix):
            continue
        *path, last = key[len(prefix):].split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = value
    return tree


# one train step of each remaining family on a mesh (tests/test_torch_lm_mesh_*.py);
# "changes" are applied to the reduced config on both sides, "group" names the
# test file that runs the case, and a (1, 2) mesh runs on the two-rank world
FAMILY_TRAIN = {
    "internvl2 data 2 x model 2": dict(
        arch="internvl2-2b", mesh=(2, 2), micro=2, batch=(8, 32), group="vlm_moe"),
    "qwen2-moe data 1 x model 4": dict(
        arch="qwen2-moe-a2.7b", mesh=(1, 4), micro=1, batch=(2, 64), group="vlm_moe"),
    "qwen2-moe data 2 x model 2": dict(
        arch="qwen2-moe-a2.7b", mesh=(2, 2), micro=1, batch=(4, 32), group="vlm_moe"),
    "qwen2-moe 6 experts data 1 x model 4": dict(
        arch="qwen2-moe-a2.7b", changes=dict(n_experts=6), mesh=(1, 4), micro=1,
        batch=(2, 32), group="vlm_moe"),
    "deepseek-v2 data 1 x model 4": dict(
        arch="deepseek-v2-236b", mesh=(1, 4), micro=1, batch=(2, 32), group="vlm_moe"),
    "mamba2 data 2 x model 2": dict(
        arch="mamba2-780m", mesh=(2, 2), micro=1, batch=(4, 64), group="recurrent"),
    "recurrentgemma data 1 x model 4": dict(
        arch="recurrentgemma-9b", mesh=(1, 4), micro=1, batch=(2, 64), group="recurrent"),
    "whisper data 1 x model 2": dict(
        arch="whisper-tiny", mesh=(1, 2), micro=1, batch=(2, 32), group="encdec"),
    "whisper 6 heads data 1 x model 4": dict(
        arch="whisper-tiny", changes=dict(n_heads=6, n_kv_heads=6, d_model=384, head_dim=64),
        mesh=(1, 4), micro=1, batch=(2, 64), group="encdec"),
}
FRONTEND = {"vlm": "patch_embeds", "encdec": "frames"}


def family_cases(group: str, world: int | None = None) -> dict:
    """The cases of ``group`` (those whose mesh spans ``world`` ranks)."""
    return {name: case for name, case in FAMILY_TRAIN.items() if case["group"] == group
            and (world is None or int(np.prod(case["mesh"])) == world)}


def family_cfg(registry, case):
    """The case's reduced config from ``registry`` (the port's or the
    reference's)."""
    return dataclasses.replace(registry.get(case["arch"]).reduced(), **case.get("changes", {}))


def family_batch(cfg, case, seed: int) -> dict:
    """Seeded numpy inputs of the case: int32 tokens and, for the vlm and
    encdec families, float32 patches or frames."""
    b, s = case["batch"]
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(size=(b, cfg.n_patches, cfg.d_frontend)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def family_params(arrays: dict, prefix: str, cfg) -> dict:
    """The parameter tree of a case under ``prefix`` of flat ``arrays``
    (the hybrid family's empty tail restored)."""
    tree = unflatten(arrays, prefix)
    if cfg.family == "hybrid":
        tree.setdefault("tail", [])
    return tree
