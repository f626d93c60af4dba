#!/usr/bin/env python3
"""Time the routes to U and S of the port's SVDs on one NVIDIA card.

    python3 scripts/torch_svd_routes.py

Run from the root of a checkout.  ``dsvd.left_svd`` takes U and S of an
[m, n] matrix (or a batch) from the R of a QR of its tall transpose,
factored as a tree of batched QRs of ``dsvd.QR_BLOCK_ROWS``-row blocks,
then the SVD of the small R.  At the svd method's shapes (a creditcard
hidden layer's per-output [24, 28, 255,883]; a fleet layer's [64 x 24, 28,
3,998]; the fleet merge's [32 x 29, 28, 56]; the encoder's local [29,
63,971], the fleet's [64, 29, 3,998] and its merge [32, 29, 58]) this
prints, on CUDA events (median of 10 after 2 warm-ups), the time of

* ``torch.linalg.svd(a, full_matrices=False)`` (U, S and the right factors);
* one QR of the tall transpose (``torch.linalg.qr(aᵀ, mode="r")``) + the
  SVD of R;
* ``dsvd.left_svd`` (the tree of QRs + the SVD of R);

each with max|U S² Uᵀ - a aᵀ| / max|a aᵀ| (a aᵀ in float64); and at the
three tallest shapes the tree with blocks of 64, 128, 256 and 512 rows
(``QR_BLOCK_ROWS`` is the planned one).  Then, host
clock around each call ending in ``torch.cuda.synchronize()`` (median of 5
after a warm-up), the one-shot creditcard svd fit, the 64-tenant svd fleet
fit and the gram fleet merge 64 -> 32 of ``chip_smoke.py``'s cells, with
``dsvd.left_svd`` as it is and with it replaced by ``torch.linalg.svd``,
in turns (plain, tree, tree, plain).
"""
from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SHAPES = {
    "creditcard hidden layer, per output": (24, 28, 255_883),
    "fleet hidden layer, per tenant and output": (64 * 24, 28, 3_998),
    "fleet factor merge": (32 * 29, 28, 56),
    "encoder local SVD (one of 4 partitions)": (1, 29, 63_971),
    "fleet encoder local SVDs": (64, 29, 3_998),
    "fleet encoder merge": (32, 29, 58),
}


def _svd_plain(a):
    import torch

    u, s, _ = torch.linalg.svd(a, full_matrices=False)
    return u, s


def _one_qr(a):
    import torch

    r = torch.linalg.qr(a.transpose(-1, -2), mode="r").R
    u, s, _ = torch.linalg.svd(r.transpose(-1, -2), full_matrices=False)
    return u, s


def _err(route, a, g64):
    u, s = route(a)
    g = (u * (s * s).unsqueeze(-2)).double() @ u.double().transpose(-1, -2)
    return float((g - g64).abs().max() / g64.abs().max())


def _host_ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    import torch

    from repro_torch.core import daef, dsvd, fleet

    card = cs.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    routes = {"torch.linalg.svd": _svd_plain, "one QR + SVD of R": _one_qr,
              "dsvd.left_svd (tree of QRs)": dsvd.left_svd}
    for label, (b, m, n) in SHAPES.items():
        a = torch.randn((b, m, n), generator=gen, device="cuda").squeeze(0)
        g64 = a.double() @ a.double().transpose(-1, -2)
        cs.say("svd", f"{label} {list(a.shape)}: " + "; ".join(
            f"{name} {cs.cuda_ms(lambda: route(a), reps=10, warmup=2):.3f} ms "
            f"(U S^2 U^T {_err(route, a, g64):.1e})" for name, route in routes.items()))
        if a.shape[-1] > 2 * dsvd.QR_BLOCK_ROWS:
            def tree(rows):
                r = dsvd._tall_r(a.transpose(-1, -2), rows)
                return torch.linalg.svd(r.transpose(-1, -2), full_matrices=False)

            cs.say("svd", f"{label}: the tree with blocks of " + ", ".join(
                f"{rows} rows {cs.cuda_ms(lambda: tree(rows), reps=10, warmup=2):.3f} ms"
                for rows in (64, 128, 256, 512)) + f" (planned {dsvd.QR_BLOCK_ROWS})")
        del a, g64

    cfg = daef.DAEFConfig(**cs.CREDITCARD, stats_backend="fused")
    cfg_s = dataclasses.replace(cfg, method="svd")
    (_, _, _), (xtr, _) = cs.load_data()
    (_, seeds, _, _), (xs_d, _) = cs.load_fleet_data()
    gram_fleet = fleet._fit_fleet(cfg, xs_d, seeds=seeds)
    calls = {
        "svd fit": lambda: daef.fit(cfg_s, xtr, n_partitions=cs.N_PARTITIONS),
        "svd fleet fit": lambda: fleet._fit_fleet(cfg_s, xs_d, seeds=seeds),
        "gram fleet merge 64 -> 32": lambda: fleet.fleet_merge_pairwise(cfg, gram_fleet),
    }
    tree = dsvd.left_svd
    for label, call in calls.items():
        got = []
        for name in ("plain", "tree", "tree", "plain"):
            dsvd.left_svd = _svd_plain if name == "plain" else tree
            got.append(f"{name} {_host_ms(call):.2f}")
        dsvd.left_svd = tree
        cs.say("svd", f"{label}, host clock ms (median of 5), dsvd.left_svd as "
               + ", ".join(got))
    cs.say("svd", card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"{Path(__file__).name}: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
