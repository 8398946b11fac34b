"""Data pipeline: deterministic synthetic batches, the port of the
reference's ``repro.data.pipeline`` (``batch_shapes``,
``_structured_tokens``, ``make_batch``).  numpy only: the same seed gives
the reference's tokens, bit for bit.

Batch trees per family:
  LM (dense/moe/hybrid/ssm):  {"tokens": (B, S) int32}
  VLM:   {"tokens": (B, S_text) int32, "patch_embeds": (B, P, 1024) f32}
  audio: {"frames": (B, T, 512) f32, "targets": (B, T) int32,
          "mask": (B, T) bool}

Not yet: ``input_specs`` (the dry run), ``SyntheticDataset`` and
``prefetch`` (training).
"""
from __future__ import annotations

import numpy as np

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

Batch = dict


def batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    if cfg.family == "vlm":
        p = cfg.num_patches
        return {
            "tokens": ((batch, seq - p), np.int32),
            "patch_embeds": ((batch, p, model_lib.VISION_FEAT_DIM),
                             np.float32),
        }
    if cfg.family == "audio":
        return {
            "frames": ((batch, seq, model_lib.AUDIO_FEAT_DIM), np.float32),
            "targets": ((batch, seq), np.int32),
            "mask": ((batch, seq), np.bool_),
        }
    return {"tokens": ((batch, seq), np.int32)}


def _structured_tokens(rng, shape, vocab: int) -> np.ndarray:
    """Learnable synthetic stream: mostly-deterministic successor chain
    (token[t+1] = token[t] + stride, 10% noise) over a Zipf-ish start."""
    b, s = shape
    start = (rng.zipf(1.5, size=(b,)) - 1) % vocab
    stride = rng.integers(1, 7, size=(b, 1))
    toks = (start[:, None] + stride * np.arange(s)[None, :]) % vocab
    noise = rng.random((b, s)) < 0.1
    toks = np.where(noise, rng.integers(0, vocab, size=(b, s)), toks)
    return toks.astype(np.int32)


def make_batch(cfg: ModelConfig, batch: int, seq: int, *,
               seed: int = 0, structured: bool = True) -> Batch:
    """One deterministic host-numpy batch."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dtype) in batch_shapes(cfg, batch, seq).items():
        if dtype == np.int32:
            if k == "tokens" and structured:
                out[k] = _structured_tokens(rng, shape, cfg.vocab_size)
            else:
                hi = cfg.vocab_size if k in ("tokens", "targets") else 2
                out[k] = rng.integers(0, hi, size=shape, dtype=np.int32)
        elif dtype == np.bool_:
            out[k] = rng.random(shape) < 0.5
        else:
            out[k] = rng.standard_normal(shape).astype(np.float32)
    return out


__all__ = ["batch_shapes", "make_batch"]
