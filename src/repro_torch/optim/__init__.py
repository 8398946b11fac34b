"""Optimizers (AdamW, Adafactor), LR schedules, global-norm clipping and
gradient compression: the port of the reference's ``repro.optim``, as
plain tensor ops.  An optimizer is a pair ``init(params) -> state`` and
``update(grads, state, params, step=None) -> (params, state)``; the
update writes into the tensors it was given."""
from repro_torch.optim.adamw import Optimizer, adafactor, adamw, make_optimizer
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compress import (compress_bf16, compress_int8_ef,
                                        decompress_int8, init_residuals)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup, warmup_cosine)

__all__ = [
    "Optimizer", "adamw", "adafactor", "make_optimizer",
    "constant", "cosine_decay", "linear_warmup", "warmup_cosine",
    "clip_by_global_norm", "global_norm",
    "compress_bf16", "compress_int8_ef", "decompress_int8", "init_residuals",
]
