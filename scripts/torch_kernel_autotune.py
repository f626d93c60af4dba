#!/usr/bin/env python3
"""Measure the einsum-vs-fused verdict that ``stats_backend="auto"`` takes on
one NVIDIA card, and record it in the port's autotune cache.

    python3 scripts/torch_kernel_autotune.py                 # measure, print
    python3 scripts/torch_kernel_autotune.py --write-cache   # and record it

Run from the root of a checkout, on a machine with a card.  The port's
counterpart of ``benchmarks/kernel_autotune.py``'s ``backend_verdict``: on
that script's largest shape, (m, n, o) = (17, 2,048, 16), it times
``stats_backend.gram_stats`` on the einsum route and on the fused CUDA
kernel (B1) with CUDA events (median of 25 after warm-up) and prefers the
faster.  Beside it, on each of that script's shapes, it times each kind it
sweeps (one-shot statistics B1, accumulating B2, the fused chunk
fold B3) against its einsum route.  ``--write-cache`` merges the verdict
into ``$REPRO_AUTOTUNE_CACHE`` or the committed
``src/repro_torch/kernels/autotune_cache.json`` under the platform
``"cuda"``.  The port's CUDA wrappers take no sample-axis block (each plans
its slices from the SM count), so there is no block sweep.  The card's
``nvidia-smi`` name and power limit are printed beside the numbers, and the
last line is a JSON object of them; no file but the cache is written.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# (m, n, o): feature rows of xa, samples, outputs (the reference sweep's).
SHAPES = [(9, 1024, 8), cs.VERDICT_SHAPE]
KINDS = ("stats", "stats_acc", "fused_chunk")


def _problem(m: int, n: int, o: int, seed: int = 0) -> dict:
    """The reference sweep's problem at (m, n, o), on the card: the
    fused-chunk problem is an ELM-AE layer o -> m - 1 (targets == inputs)."""
    import torch

    rng = np.random.default_rng(seed)
    arrays = dict(
        xa=rng.normal(size=(m, n)), fsq=rng.uniform(0.05, 1.0, (o, n)),
        fd=rng.normal(size=(o, n)), h=rng.normal(size=(o, n)),
        w=rng.normal(size=(o, m - 1)) / np.sqrt(o), b=rng.normal(size=(m - 1,)),
    )
    return {k: torch.as_tensor(v, dtype=torch.float32, device="cuda") for k, v in arrays.items()}


def _runner(kind: str, p: dict, backend: str):
    """One call of ``kind`` through ``stats_backend`` on ``backend``; the
    folds add into accumulators made once (their values do not matter)."""
    import torch

    from repro_torch.core import stats_backend

    o, m = p["fd"].shape[0], p["xa"].shape[0]
    g = torch.zeros((o, m, m), device="cuda")
    mm = torch.zeros((o, m), device="cuda")
    if kind == "stats":
        return lambda: stats_backend.gram_stats(p["xa"], p["fsq"], p["fd"], backend=backend)
    if kind == "stats_acc":
        return lambda: stats_backend.gram_stats_acc(g, mm, p["xa"], p["fsq"], p["fd"],
                                                    backend=backend)
    return lambda: stats_backend.fused_chunk_acc(g, mm, p["h"], p["w"], p["b"], act="logsig",
                                                 backend=backend)


def sweep() -> list[dict]:
    records = []
    for m, n, o in SHAPES:
        p = _problem(m, n, o)
        for kind in KINDS:
            ms = {b: cs.cuda_ms(_runner(kind, p, b)) for b in ("einsum", "fused")}
            records.append({"kind": kind, "shape": {"m": m, "n": n, "o": o},
                            "einsum_ms": ms["einsum"], "fused_ms": ms["fused"]})
            print(f"{kind} m={m} n={n} o={o}: einsum {ms['einsum']:.4f} ms, fused "
                  f"{ms['fused']:.4f} ms", flush=True)
    return records


def backend_verdict() -> dict:
    """einsum against fused ``gram_stats`` on the largest shape: what
    ``"auto"`` resolves to on the card (``chip_smoke.stats_verdict``, which
    phase 20 re-measures beside the committed verdict)."""
    rec = cs.stats_verdict()
    print(f"verdict m={rec['shape']['m']} n={rec['shape']['n']} o={rec['shape']['o']}: einsum "
          f"{rec['einsum_ms']:.4f} ms, fused {rec['fused_ms']:.4f} ms -> preferred "
          f"'{rec['preferred_backend']}'", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--write-cache", action="store_true",
                    help="record the verdict under platform 'cuda' in the autotune cache")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.kernels import autotune

    if not torch.cuda.is_available():
        print("torch_kernel_autotune: no CUDA card; the verdict is measured on one",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "kind": torch.cuda.get_device_name(0), "sweep": sweep(),
              "verdict": backend_verdict()}
    if args.write_cache:
        autotune.update_cache(platform="cuda", preferred=result["verdict"]["preferred_backend"])
        result["cache_path"] = str(autotune.cache_path())
        print(f"wrote preferred backend '{result['verdict']['preferred_backend']}' for "
              f"platform 'cuda' to {autotune.cache_path()}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
