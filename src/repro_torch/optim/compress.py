"""Gradient compression, the port of ``repro.optim.compress``.

  * ``compress_bf16``: float leaves cast to bf16 (round to nearest
    even, as XLA casts), the train step's ``grad_wire="bf16"``;
  * ``compress_int8_ef``: per-tensor symmetric int8 with error feedback
    (the quantization residual carried to the next step).

On one device there is no all-reduce for the narrow dtype to cross: the
train step keeps the reference's numerics, a round trip through the
wire dtype, and the multi-device stack will put the collective there.
"""
from __future__ import annotations

import torch

from repro_torch.tree import map_tree


def compress_bf16(tree):
    """Cast float leaves to bf16 (wire dtype).  Int leaves pass through."""
    def c(x):
        if x.is_floating_point() and x.dtype != torch.bfloat16:
            return x.to(torch.bfloat16)
        return x
    return map_tree(c, tree)


def _q_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, scale): x / scale correctly rounded, then rounded half to
    even (``torch.round``, as ``jnp.round``; never half away from zero)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def compress_int8_ef(grads, residuals):
    """Quantize ``grads + residuals`` to int8; return (tree of (q, scale)
    pairs, new residual tree)."""
    def c(g, r):
        g32 = g.float() + r
        q, scale = _q_int8(g32)
        return (q, scale), g32 - q.float() * scale

    out = map_tree(c, grads, residuals)
    pair = lambda x: isinstance(x, tuple) and isinstance(x[0], tuple)
    qt = map_tree(lambda o: o[0], out, is_leaf=pair)
    res = map_tree(lambda o: o[1], out, is_leaf=pair)
    return qt, res


def decompress_int8(qtree):
    return map_tree(lambda pair: pair[0].float() * pair[1], qtree,
                    is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
                    and isinstance(x[0], torch.Tensor))


def init_residuals(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


__all__ = ["compress_bf16", "compress_int8_ef", "decompress_int8",
           "init_residuals"]
