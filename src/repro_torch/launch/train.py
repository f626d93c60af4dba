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

What waits: ``--model-parallel`` > 1 shards the model over a device mesh,
ROADMAP queue A item 12.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
      --steps 20 --batch 8 --seq 128 --ckpt /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import registry
from repro_torch.core import threefry
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import get_bundle
from repro_torch.train import checkpoint

MESH_ITEM = "ROADMAP queue A item 12"
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
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    bundle = get_bundle(cfg, chunked_attn=args.seq > 2048)
    if args.model_parallel > 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel} shards the model over a device "
            f"mesh, which is not ported to repro_torch yet ({MESH_ITEM})")
    dev = resolve_device(args.device)

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
        return batch

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        params, opt_state, loss = step_fn(params, opt_state, make_batch(step))
        losses.append(float(loss))  # waits for the step
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"({(time.time()-t0)/(step+1):.2f} s/step)", flush=True)
    _sync(dev)
    if args.ckpt:
        path = checkpoint.save(args.ckpt, {"params": params}, step=args.steps)
        print(f"checkpoint written to {path}")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    print(f"loss {first:.4f} -> {last:.4f} ({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
