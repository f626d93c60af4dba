"""Architecture registry: ``--arch <id>`` lookup + the assigned shape matrix."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.configs import (
    deepseek_v2_236b,
    granite_20b,
    internvl2_2b,
    mamba2_780m,
    mistral_nemo_12b,
    qwen2_1p5b,
    qwen2_moe_a2p7b,
    qwen3_1p7b,
    recurrentgemma_9b,
    whisper_tiny,
)

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        whisper_tiny.CONFIG,
        internvl2_2b.CONFIG,
        recurrentgemma_9b.CONFIG,
        mistral_nemo_12b.CONFIG,
        granite_20b.CONFIG,
        qwen3_1p7b.CONFIG,
        deepseek_v2_236b.CONFIG,
        qwen2_1p5b.CONFIG,
        qwen2_moe_a2p7b.CONFIG,
        mamba2_780m.CONFIG,
    ]
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic state. Native: ssm/hybrid.  Dense/VLM/MoE run
# the sliding-window (4096) variant.  whisper-tiny is skipped (DESIGN.md §4).
LONG_CTX_WINDOW = 4096
LONG_CTX_SKIP = {"whisper-tiny"}


def get(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError as e:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}") from e


def for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Shape-specific config adjustments (the sliding-window long-ctx variant)."""
    if shape.name == "long_500k" and cfg.family in ("dense", "vlm", "moe"):
        return dataclasses.replace(cfg, sliding_window=LONG_CTX_WINDOW)
    return cfg


def supported(cfg: ArchConfig, shape: InputShape) -> bool:
    if shape.name == "long_500k" and cfg.name in LONG_CTX_SKIP:
        return False
    return True


def matrix() -> list[tuple[ArchConfig, InputShape]]:
    """All assigned (arch x shape) pairs, including documented skips."""
    return [
        (cfg, shape)
        for cfg in ARCHS.values()
        for shape in SHAPES.values()
    ]
