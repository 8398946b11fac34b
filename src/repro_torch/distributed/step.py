"""Step builders for serving: prefill and decode on one device, the port
of the reference's ``make_prefill_step`` and ``make_decode_step``
(``repro.distributed.step``).

The reference jits each step over a mesh and donates the caches
(``donate_argnums=(2,)``) so that XLA updates them in place; here a step
is a plain callable on one device that writes into the preallocated
cache tensors (:func:`repro_torch.models.model.init_caches`) in place and
returns them.  Not yet: ``make_train_step`` (the training slice) and the
mesh.  hubert (encoder-only) builds both steps, as in the reference; its
server runs no decode (``launch.serve``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.data.pipeline import batch_shapes
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

# the batch entries each family's forward reads (data.pipeline's trees;
# an audio batch's targets and mask are the training loss's)
_INPUTS = {"vlm": ("tokens", "patch_embeds"), "audio": ("frames",)}


def _check(what: str, got: tuple, want: tuple) -> None:
    if tuple(got) != tuple(want):
        raise ValueError(f"{what}: shape {tuple(got)}, the step was built "
                         f"for {tuple(want)}")


def make_prefill_step(cfg: ModelConfig, *, batch_size: int,
                      seq_len: int) -> Callable:
    """``prefill(params, batch, caches) -> (last logits (B, V), caches)``:
    forward the whole prompt, fill the caches, return the last
    position's logits.  ``seq_len`` counts every position: a vlm
    prompt's patches and tokens (``data.pipeline.batch_shapes``)."""
    shapes = batch_shapes(cfg, batch_size, seq_len)
    want = {k: shapes[k][0] for k in _INPUTS.get(cfg.family, ("tokens",))}

    def prefill(params, batch, caches):
        for k, shape in want.items():
            _check(f"prefill {k}", batch[k].shape, shape)
        logits, caches, _ = model_lib.forward(params, batch, cfg,
                                              caches=caches)
        return logits[:, -1], caches

    return prefill


def make_decode_step(cfg: ModelConfig, *, batch_size: int,
                     cache_len: int) -> Callable:
    """``decode(params, tokens, caches) -> (next tokens, logits, caches)``:
    one greedy token against ``cache_len``-long caches (the attention
    caches' length; a recurrent state has none, only a batch axis)."""
    w = cfg.local_window
    size = min(cache_len, w) if w else cache_len

    def decode(params, tokens, caches):
        _check("decode tokens", tokens.shape, (batch_size,))
        every = [c for sb in caches["stack"] for c in sb.values()]
        every += caches["tail"]
        attn = [c for c in every if "k" in c]
        if attn:
            _check("decode cache", attn[0]["k"].shape[:2],
                   (batch_size, size))
        else:
            state = next(iter(every[0].values()))
            _check("decode state", state.shape[:1], (batch_size,))
        logits, caches = model_lib.decode_step(params, tokens, caches, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, caches

    return decode


__all__ = ["make_prefill_step", "make_decode_step"]
