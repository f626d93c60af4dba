"""Training launcher: real steps of an LM on the card (counterpart of
``repro/launch/train.py``).

LM training of a registered arch (reduced or full config) on synthetic
token streams: the full train step (microbatching, AdamW under a warmup +
cosine schedule, global-norm clipping) end to end, with a checkpoint in the
reference's layout.  The same flags as the reference's, plus ``--device``
(the card by default, ``cpu`` on a host without one) and ``--dtype`` (the
parameters' dtype: float32, the reference's ``bundle.init`` default, or
bfloat16, where attention runs B7 and B8 on their tensor-core routes).

Every family trains (dense, vlm, moe, ssm, hybrid, encdec); the vlm
family's batches carry ``patch_embeds`` and the encdec family's ``frames``
(the bits of the reference's ``jax.random.normal(PRNGKey(step), ...)``,
drawn by ``core.threefry``; the frames cast to ``--dtype``).  On the card
the ssm and hybrid families' gradients go through the B10 and B9 backward
kernels.

``--model-parallel M`` > 1 trains any arch of any family on a ("data",
"model") mesh: the reference's ``make_host_mesh(M)`` with
``param_shardings`` and ``batch_shardings`` (``launch/shardings.py``,
``models/hints.py``; the patches and frames split with the tokens).  The
CLI starts itself once per rank and relays rank 0's output.  On the card
each rank takes its own card under NCCL and the mesh spans every card,
(count / M, M), as the reference's spans ``jax.devices()``; fewer cards
than the mesh needs is an error.  With ``--device cpu`` the host has no
device count to span: M gloo ranks make a (1, M) mesh.  ``--ckpt``
gathers the full leaves and rank 0 writes the reference's layout.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
      --steps 20 --batch 8 --seq 128 --ckpt /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import registry
from repro_torch.core import threefry
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_mod
from repro_torch.models import get_bundle, hints
from repro_torch.train import checkpoint

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=sorted(registry.ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES),
                    help="the parameters' dtype (float32 as the reference's init)")
    ap.add_argument("--device", default=None,
                    help="where the port runs: the CUDA card by default, "
                         "'cpu' on a host without one")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.model_parallel < 1:
        ap.error(f"--model-parallel must be >= 1, got {args.model_parallel}")
    if args.model_parallel > 1 and args.rank is None:
        _spawn_ranks(args, list(sys.argv[1:] if argv is None else argv))
        return
    if args.rank is None:
        _train(args, cfg, resolve_device(args.device), None)
        return
    dev = mesh_lib.rank_device(args.device)
    if dev.type == "cpu":  # the host's cores shared out among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.world))
    mesh_lib.init_process_group_from_file(args.store, args.rank, args.world,
                                          backend=mesh_lib.rank_backend(args.device))
    try:
        mesh = mesh_lib.make_host_mesh(args.model_parallel, device=dev)
        with hints.use_mesh(mesh):
            _train(args, cfg, mesh.device, mesh)
    finally:
        torch.distributed.destroy_process_group()


def _spawn_ranks(args, argv: list) -> None:
    """Run this CLI once per rank of the ("data", "model") mesh and relay
    rank 0's output: the ranks share a ``FileStore`` in a temporary
    directory.  On the card one rank a card under NCCL, every card in the
    mesh; with ``--device cpu`` ``--model-parallel`` gloo ranks."""
    m = args.model_parallel
    if mesh_lib.rank_backend(args.device) == "nccl":
        world = torch.cuda.device_count()
        if world < m or world % m:
            raise SystemExit(
                f"error: --model-parallel {m} on the card needs a multiple of {m} cards, one "
                f"a rank under NCCL; {world} present (pass --device cpu to run {m} ranks on "
                "the host)")
    else:
        world = m
    mesh_lib.spawn_ranks("repro_torch.launch.train", argv, world, lambda r, store: [
        "--rank", str(r), "--world", str(world), "--store", store])


def _train(args, cfg, dev: torch.device, mesh) -> None:
    """The training loop; on a mesh, this rank's slices of the parameters
    and rows of each batch, and rank 0 prints."""
    from repro_torch.launch import shardings

    bundle = get_bundle(cfg, chunked_attn=args.seq > 2048)
    lead = mesh is None or mesh.rank == 0
    params = bundle.init(0, DTYPES[args.dtype], device=dev)
    opt = optim.adamw(
        optim.linear_warmup_cosine(args.lr, args.steps // 10 + 1, args.steps),
        weight_decay=0.01,
    )
    opt_state = opt.init(params)
    step_fn = steps_mod.make_train_step(bundle, opt, microbatches=args.microbatches)

    def make_batch(step: int) -> dict:
        batch = {
            "tokens": torch.as_tensor(
                synthetic.lm_token_stream(cfg.vocab_size, args.seq, args.batch, seed=step),
                device=dev)
        }
        if cfg.family == "vlm":
            batch["patch_embeds"] = threefry.normal(
                threefry.PRNGKey(step), (args.batch, cfg.n_patches, cfg.d_frontend)).to(dev)
        if cfg.family == "encdec":
            # in the parameters' dtype: the decoder takes no wider encoder states
            batch["frames"] = threefry.normal(
                threefry.PRNGKey(step), (args.batch, cfg.encoder_seq, cfg.d_model)).to(
                    dev, DTYPES[args.dtype])
        if mesh is not None:
            batch = shardings.shard_tree(batch, shardings.batch_shardings(batch, mesh), mesh)
        return batch

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        params, opt_state, loss = step_fn(params, opt_state, make_batch(step))
        losses.append(float(loss))  # waits for the step
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"({(time.time()-t0)/(step+1):.2f} s/step)", flush=True)
    _sync(dev)
    if args.ckpt:
        tree = {"params": params}
        if mesh is not None:
            tree = {"params": shardings.gather_tree(
                params, shardings.lm_param_specs(cfg, mesh), mesh)}
        if lead:
            path = checkpoint.save(args.ckpt, tree, step=args.steps)
            print(f"checkpoint written to {path}")
    if lead:
        first, last = np.mean(losses[:3]), np.mean(losses[-3:])
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
