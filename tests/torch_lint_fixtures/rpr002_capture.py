"""RPR002 fixture (the port's): env reads inside a CUDA-graph capture."""
import os

import torch
from torch.cuda import graph as capture


def bad_env_in_capture(g, x):
    with torch.cuda.graph(g):
        if os.environ.get("REPRO_FIXTURE_FAST") == "1":      # line 10: RPR002
            x.mul_(2)


def bad_getenv_in_aliased_capture(g, x):
    with capture(g):
        x.mul_(float(os.getenv("REPRO_FIXTURE_SCALE", "1")))  # line 16: RPR002


def clean_resolved_before_capture(g, x):
    """The stats_backend idiom: resolve at call time, before the capture."""
    scale = float(os.environ.get("REPRO_FIXTURE_SCALE", "1"))
    with torch.cuda.graph(g):
        x.mul_(scale)
    return scale


def clean_other_context(x):
    with torch.no_grad():
        return x * float(os.environ.get("REPRO_FIXTURE_SCALE", "1"))
