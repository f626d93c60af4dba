"""Synthetic replicas of the paper's anomaly-detection datasets (numpy only).

The port's own copy of the replica generator in ``repro/data/synthetic.py``,
so that a machine without jax makes the same data: the same name, seed and
scale give the same arrays as the reference.  Keep the two in step.

The UCI/Kaggle data of the paper's Table 1 is not shipped.  Each replica
reproduces the *statistical shape* of its dataset — size, dimension and
anomaly rate — with normal samples on a random nonlinear low-rank manifold
(rank ~ dim/3) plus noise, and anomalies drawn off-manifold (scaled isotropic
+ manifold-orthogonal shifts).  Absolute F1 values are not comparable to the
paper's.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

# name -> (n_total, anomalies, dim)  — paper Table 1
PAPER_DATASETS: dict[str, tuple[int, int, int]] = {
    "shuttle": (49097, 3511, 9),
    "covertype": (286048, 2747, 10),
    "pendigits": (6870, 156, 16),
    "cardio": (1831, 176, 21),
    "creditcard": (284807, 492, 29),
    "ionosphere": (351, 126, 33),
    "optdigit": (5216, 64, 62),
}


@dataclasses.dataclass
class AnomalyDataset:
    """Column-major (features x samples) like the paper."""

    name: str
    x_normal: np.ndarray    # [dim, n_normal]
    x_anomaly: np.ndarray   # [dim, n_anomaly]

    @property
    def dim(self) -> int:
        return self.x_normal.shape[0]

    def train_test_split(self, fold: int, n_folds: int = 10):
        """Paper protocol: train on normal only (k-fold over normals); test on
        held-out normals + an equal-sized anomaly sample (50/50)."""
        n = self.x_normal.shape[1]
        idx = np.arange(n)
        rng = np.random.default_rng(1234)
        rng.shuffle(idx)
        lo, hi = round(fold * n / n_folds), round((fold + 1) * n / n_folds)
        test_idx, train_idx = idx[lo:hi], np.concatenate([idx[:lo], idx[hi:]])
        x_train = self.x_normal[:, train_idx]
        x_test_norm = self.x_normal[:, test_idx]
        n_anom = min(self.x_anomaly.shape[1], x_test_norm.shape[1])
        a_idx = np.random.default_rng(fold).choice(
            self.x_anomaly.shape[1], size=n_anom, replace=False
        )
        x_test = np.concatenate([x_test_norm, self.x_anomaly[:, a_idx]], axis=1)
        y_test = np.concatenate(
            [np.zeros(x_test_norm.shape[1]), np.ones(n_anom)]
        ).astype(np.int32)
        return x_train, x_test, y_test


def make_dataset(name: str, seed: int = 0, scale: float = 1.0) -> AnomalyDataset:
    """Generate the synthetic replica of a paper dataset.

    ``scale`` < 1 shrinks the sample count (for fast tests) while keeping
    dim and anomaly rate.
    """
    n_total, n_anom, dim = PAPER_DATASETS[name]
    rate = n_anom / n_total
    n_total = max(64, int(n_total * scale))
    # Preserve the paper's anomaly rate under scaling.
    n_anom = max(4, round(n_total * rate))
    n_norm = n_total - n_anom
    # zlib.crc32, not hash(): Python string hashing is randomized per
    # process and would make "deterministic" datasets differ across runs.
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2**31))

    rank = max(2, dim // 3)
    mix = rng.normal(size=(dim, rank)) / np.sqrt(rank)
    bend = rng.normal(size=(dim, rank)) / np.sqrt(rank)

    def sample_normal(n):
        z = rng.normal(size=(rank, n))
        x = mix @ z + 0.6 * np.tanh(bend @ (z * z - 1.0))
        return x + 0.08 * rng.normal(size=(dim, n))

    x_norm = sample_normal(n_norm)

    # Anomalies: a blend of (a) isotropic far-field noise and (b) on-manifold
    # points pushed along directions orthogonal to the manifold.
    n_a1 = n_anom // 2
    a1 = 2.2 * rng.normal(size=(dim, n_a1))
    base = sample_normal(n_anom - n_a1)
    q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    ortho = q[:, rank:]
    push = ortho @ rng.normal(size=(ortho.shape[1], n_anom - n_a1))
    a2 = base + 1.8 * push / np.maximum(np.linalg.norm(push, axis=0, keepdims=True), 1e-9)
    x_anom = np.concatenate([a1, a2], axis=1)

    # Standard-scale using the normal-class statistics (paper: zero mean /
    # unit variance scalers).
    mean = x_norm.mean(axis=1, keepdims=True)
    std = x_norm.std(axis=1, keepdims=True) + 1e-9
    return AnomalyDataset(
        name=name,
        x_normal=((x_norm - mean) / std).astype(np.float32),
        x_anomaly=((x_anom - mean) / std).astype(np.float32),
    )
