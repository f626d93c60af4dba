"""The rounding floor of an LM's float32 gradients on the card: the same
loss's gradients over a batch at once and as two microbatches of half the
rows (the mean of theirs), per leaf as a share of 1e-4 x max|leaf|, the
bar that ``chip_smoke.py``'s lm-mesh phase holds a mesh's gradients to.
A share near 1 means the bar cannot tell a layout's fault from float32
summing the same terms in another order.

    python3 scripts/torch_grad_rounding.py [--arch A] [--rows B] [--seq S] [LAYERS ...]

One line a depth (full width, random weights from seed 0, the lm-mesh
phase's batch of step 0), beside the card's name and power limit; each
line is also appended to ``chiprun_out/grad_rounding.txt``.  Needs the card.
"""
import argparse
import dataclasses
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("layers", type=int, nargs="*", default=[24, 12, 8])
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.configs import registry
    from repro_torch.models import get_bundle

    card = cs.phase_device()
    cs.phase_build()
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    half = args.rows // 2
    for layers in args.layers:
        cfg = dataclasses.replace(registry.get(args.arch), n_layers=layers)
        bundle = get_bundle(cfg)
        params = bundle.init(0, torch.float32, device="cuda")
        batch = cs._lm_mesh_batch(cfg, dict(b=args.rows, s=args.seq), 0)
        _, whole = cs._lm_mesh_grads(bundle, params, batch)
        parts = [cs._lm_mesh_grads(bundle, params, {k: v[i:i + half] for k, v in batch.items()})[1]
                 for i in (0, half)]
        shares = {}
        for k, g in whole.items():
            two = (parts[0][k] + parts[1][k]) / 2
            shares[k] = float((g - two).abs().max()) / (1e-4 * float(two.abs().max()))
        worst = sorted(shares.items(), key=lambda kv: -kv[1])[:6]
        line = (f"{args.arch} at {layers} layers, {args.rows} x {args.seq}: one batch vs two "
                f"microbatches, the worst leaves' shares of the 1e-4 bar "
                f"{[(k, round(v, 3)) for k, v in worst]} on {card}")
        print(line, flush=True)
        with open(ROOT / "chiprun_out" / "grad_rounding.txt", "a") as f:
            f.write(line + "\n")
        del params, whole, parts
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
