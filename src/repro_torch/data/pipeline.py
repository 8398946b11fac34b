"""Data pipeline: deterministic synthetic batches, the port of the
reference's ``repro.data.pipeline``.  numpy only: the same seed gives
the reference's batches, bit for bit.

  * ``SyntheticDataset``: a seeded, restart-deterministic stream (a
    step's batch is a pure function of seed, process index and step),
    host numpy, double-buffered by ``prefetch``;
  * ``input_specs``: the same tree as tensors on the ``meta`` device
    (shapes and dtypes, nothing allocated).

Batch trees per family:
  LM (dense/moe/hybrid/ssm):  {"tokens": (B, S) int32}
  VLM:   {"tokens": (B, S_text) int32, "patch_embeds": (B, P, 1024) f32}
  audio: {"frames": (B, T, 512) f32, "targets": (B, T) int32,
          "mask": (B, T) bool}
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

Batch = dict
_TORCH_DTYPES = {np.int32: torch.int32, np.float32: torch.float32,
                 np.bool_: torch.bool}


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


def input_specs(cfg: ModelConfig, batch: int, seq: int) -> Batch:
    """The batch tree as ``meta`` tensors (zero allocation)."""
    return {k: torch.empty(shape, dtype=_TORCH_DTYPES[dtype], device="meta")
            for k, (shape, dtype) in batch_shapes(cfg, batch, seq).items()}


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


class SyntheticDataset:
    """Deterministic seeded stream of batches.  ``process_index`` gives
    each data-parallel host its own disjoint stream."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

    def __iter__(self) -> Iterator[Batch]:
        step = 0
        while True:
            yield self[step]
            step += 1

    def __getitem__(self, step: int) -> Batch:
        # seed folds in (stream step, process) => restart-deterministic
        s = (self.seed * 1_000_003 + step) * 65_537 + self.process_index
        return make_batch(self.cfg, self.batch, self.seq, seed=s)


def prefetch(it: Iterator[Batch], depth: int = 2) -> Iterator[Batch]:
    """Host-side buffering on a background thread: at most ``depth``
    items ahead, in order."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item


__all__ = ["batch_shapes", "input_specs", "make_batch", "SyntheticDataset",
           "prefetch"]
