"""Production fleet serving on top of `repro_torch.engine` (counterpart of
``repro.serving``).

Continuous batching (`TilePacker` over a `RequestQueue`), a model-versioned
score/threshold cache (`ScoreCache`), additive quantile sketches for online
threshold recalibration (`ErrorSketch`), and the serving loop that ties
them together (`FleetServer`, one CUDA graph per tile shape on the card).
"""
from repro_torch.serving.cache import ScoreCache, sample_hashes
from repro_torch.serving.metrics import latency_summary, percentile
from repro_torch.serving.packer import SlotAssignment, Tile, TilePacker
from repro_torch.serving.queue import RequestQueue, ScoreRequest
from repro_torch.serving.recalibration import ErrorSketch
from repro_torch.serving.server import FleetServer, ScoreResult

__all__ = [
    "ErrorSketch",
    "FleetServer",
    "RequestQueue",
    "ScoreCache",
    "ScoreRequest",
    "ScoreResult",
    "SlotAssignment",
    "Tile",
    "TilePacker",
    "latency_summary",
    "percentile",
    "sample_hashes",
]
