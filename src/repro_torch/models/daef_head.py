"""DAEF head — the paper's technique attached to an LM backbone.

Counterpart of ``repro/models/daef_head.py``: fit a DAEF autoencoder
NON-ITERATIVELY on mean-pooled hidden states of in-distribution traffic,
then score new sequences by reconstruction error and flag those above the
fitted threshold (``examples/llm_feature_anomaly.py`` as a component).

* :func:`pooled_features` runs a backbone's forward under
  ``torch.inference_mode()`` and mean-pools its hidden states in their own
  dtype, as the reference does, then returns the features in float32 on
  the backbone's device.
* :func:`fit_head` standardises the features, fits with ``daef.fit``
  (``n_partitions`` exercising the merge path) or, with ``mesh`` given,
  through a data-sharded ``DAEFEngine`` plan (each rank's share of the
  samples one federated node), and thresholds the training errors (every
  rank's).  ``device=None`` means the card (``repro_torch.device``; the
  mesh's device with a mesh).
  :func:`default_config` is the reference's, field for field: its
  ``stats_backend=None`` defers to ``$REPRO_STATS_BACKEND``, then ``auto``.
  A caller that wants the hidden decoder layer's (G, M) folded by the B1
  kernel passes ``dataclasses.replace(cfg, stats_backend="fused")``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import anomaly, daef
from repro_torch.device import as_tensor, resolve_device


@dataclasses.dataclass
class DAEFHead:
    """A fitted DAEF anomaly head over backbone features."""

    cfg: daef.DAEFConfig
    model: daef.DAEFModel
    mean: torch.Tensor       # feature standardisation (fit on normal data)
    std: torch.Tensor
    threshold: torch.Tensor

    def score(self, feats) -> torch.Tensor:
        """feats [n, d] -> per-sample reconstruction error, on the head's device."""
        dev = self.mean.device
        x = ((as_tensor(feats, dev, self.mean.dtype) - self.mean) / self.std).T
        return daef.reconstruction_error(self.cfg, self.model, x.contiguous(), device=dev)

    def flag(self, feats) -> torch.Tensor:
        """1 = anomalous (error above the fitted threshold)."""
        return anomaly.classify(self.score(feats), self.threshold, device=self.mean.device)


def default_config(d_model: int, *, latent_frac: int = 8) -> daef.DAEFConfig:
    return daef.DAEFConfig(
        layer_sizes=(d_model, d_model // latent_frac, d_model // 4, d_model),
        lam_hidden=0.1,
        lam_last=0.5,
    )


def fit_head(
    feats,
    *,
    cfg: daef.DAEFConfig | None = None,
    rule: str = "q90",
    n_partitions: int = 4,
    mesh=None,
    data_axes=("data",),
    device=None,
) -> DAEFHead:
    """Fit a DAEF head on normal-traffic features [n, d] on ``device``.

    With ``mesh`` given, the fit runs on-mesh (each data shard = one
    federated node; every rank passes the same features); otherwise a
    one-device fit with ``n_partitions`` exercising the same merge path.
    """
    from repro_torch.engine import DAEFEngine, ExecutionPlan

    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    feats = as_tensor(feats, dev)
    mean = feats.mean(dim=0)
    std = feats.std(dim=0, unbiased=False) + 1e-6
    x = ((feats - mean) / std).T.contiguous()  # [d, n] — the paper's convention
    if cfg is None:
        cfg = default_config(x.shape[0])
    if mesh is not None:
        engine = DAEFEngine(cfg, ExecutionPlan(mode="mesh", mesh_axes=tuple(data_axes)),
                            mesh=mesh, device=device)
        model = engine.fit(x)
        thr = engine.thresholds(model, rule)
    else:
        model = daef.fit(cfg, x, n_partitions=n_partitions, device=dev)
        thr = anomaly.threshold(model.train_errors, rule, device=dev)
    return DAEFHead(cfg=cfg, model=model, mean=mean, std=std, threshold=thr)


def pooled_features(forward: Callable[..., torch.Tensor], tokens) -> torch.Tensor:
    """Mean-pool a backbone's hidden states into [batch, d] features: the
    mean in the backbone's dtype (a bf16 backbone gives bf16-rounded means,
    as the reference's ``h.mean(axis=1)`` does), returned in float32."""
    with torch.inference_mode():
        feats = forward(tokens).mean(dim=1)
    # a copy made here, outside inference mode, is an ordinary tensor
    return feats.to(torch.float32, copy=True)
