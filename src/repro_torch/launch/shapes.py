"""The assigned input-shape cells and per-arch skip rules, the port of
the reference's ``repro.launch.shapes``.

40 cells = 10 archs x 4 shapes; 31 runnable, 9 skipped:
  * ``long_500k`` needs sub-quadratic attention -> only the hybrid
    (recurrentgemma: RG-LRU + 2048-window local attention) and ssm
    (rwkv6: O(1) recurrent state) archs run it;
  * hubert-xlarge is encoder-only -> no autoregressive decode cells.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeCell("long_500k", "decode", 524_288, 1),
}

_SUBQUADRATIC = {"recurrentgemma-9b", "rwkv6-3b"}
_ENCODER_ONLY = {"hubert-xlarge"}


def skip_reason(cfg: ModelConfig, shape: ShapeCell) -> str | None:
    if cfg.name in _ENCODER_ONLY and shape.kind == "decode":
        return "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and cfg.name not in _SUBQUADRATIC:
        return "full quadratic attention: 500k decode not sub-quadratic"
    return None


def cells(arch_names, shape_names=None):
    """Yields (arch, shape, skip_reason|None) for the full grid."""
    from repro_torch.configs import get
    names = shape_names or list(SHAPES)
    for a in arch_names:
        cfg = get(a)
        for s in names:
            yield a, SHAPES[s], skip_reason(cfg, SHAPES[s])


__all__ = ["ShapeCell", "SHAPES", "skip_reason", "cells"]
