"""repro_torch — DAEF (Fast Deep Autoencoder for Federated learning) in PyTorch.

The PyTorch/CUDA counterpart of the JAX package ``repro``.  Module names
mirror ``repro`` one for one (``repro_torch.core.daef`` <-> ``repro.core.daef``)
so every file has an obvious reference.  The port imports torch, numpy and the
standard library only; it never imports jax or ``repro``.

Entry points take ``device=``: ``None`` means the CUDA card and raises when
none is present (see :mod:`repro_torch.device`); pass ``device="cpu"`` to run
on the host, as the CPU tests do.

What is ported so far is the closed-form fit of the paper's Algorithm 1
(``method="gram"``) for one tenant, one-shot (``daef.fit``) and streamed
chunk by chunk (``daef.fit_chunked``, ``daef.fit_stream``), with scoring,
classification and the federated merges (``daef.merge_models``,
``partial_fit``); and the same for a fleet of K tenants at once
(``repro_torch.fleet``: fit, chunked and streamed fits, pairwise merges,
scores, thresholds).  One engine (``repro_torch.engine.DAEFEngine`` under an
``ExecutionPlan``) drives them and the paper's federated protocol
(``FederationSession``: sync and async rounds, secure aggregation), and
checkpoints (``repro_torch.train.checkpoint``) cross with the JAX package's.  The model zoo's serving side is ported for the dense,
SSM and hybrid families (``repro_torch.models.get_bundle``: init, forward,
prefill, decode through KV, SSM and RG-LRU caches; the serve CLI's LM
mode, ``repro_torch.launch.serve``), with the DAEF head on their pooled hidden states
(``repro_torch.models.daef_head``); the dense family trains
(``repro_torch.launch.train``).  The paper's comparison baseline, the
iterative autoencoder, is ``repro_torch.baselines.autoencoder``.
``stats_backend="auto"`` takes the einsum-vs-fused verdict measured on
the card (``repro_torch.kernels.autotune``).  ROADMAP.md lists what waits.
"""
from repro_torch import models
from repro_torch.core import fleet
from repro_torch.device import DEFAULT_DTYPE, as_tensor, resolve_device

__all__ = ["DEFAULT_DTYPE", "as_tensor", "fleet", "models", "resolve_device"]
