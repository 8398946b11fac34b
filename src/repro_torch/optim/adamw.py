"""AdamW and Adafactor as plain tensor ops, the port of
``repro.optim.adamw``.

An optimizer is ``init(params) -> state`` and ``update(grads, state,
params, step=None) -> (params, state)``, as in the reference, except
that ``update`` writes the new parameters and state into the tensors it
was given (the reference's donated buffers) and returns them.  Each
leaf's arithmetic is the reference's, in f32, in its order: a parameter
of the training layout keeps the repeat axis of the stack
(:mod:`repro_torch.models.convert`), so AdamW decays, and Adafactor
factors and clips, exactly the leaves the reference does, stacked norm
scales and biases included.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable      # params -> opt_state
    update: Callable    # (grads, state, params, step) -> (params, state)
    name: str = ""
    # (grads, states, params, mean, step): ``update`` over a leaf's blocks
    # held apart (one tree a block), for an update that is not elementwise
    # (Adafactor's means); None where ``update`` on each block is the same
    update_blocks: Optional[Callable] = None


def _count0(params) -> torch.Tensor:
    first = leaves(params)
    dev = first[0].device if first else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _store(dst: torch.Tensor, val: torch.Tensor) -> None:
    """``val`` (f32) into ``dst``, cast to its dtype; no copy where
    ``val`` is ``dst`` itself (an f32 leaf updated in place)."""
    if val is not dst:
        dst.copy_(val)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(lr_fn, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    """Decoupled-weight-decay Adam (Loshchilov & Hutter)."""

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                      device=p.device)
        return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
                "count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params, step=None):
        count = state["count"].add_(1)
        lr = lr_fn(count if step is None else step)
        c1 = 1.0 - torch.pow(b1, count.float())
        c2 = 1.0 - torch.pow(b2, count.float())

        def upd(g, m, v, p):
            g32 = g.float()
            m_new = m.float().mul_(b1).add_(g32, alpha=1 - b1)
            v_new = v.float().mul_(b2).addcmul_(g32, g32, value=1 - b2)
            delta = m_new / c1
            delta.div_((v_new / c2).sqrt_().add_(eps))
            p32 = p.float()
            # decay only matrices: a leaf of 2 or more axes (a stacked
            # norm scale, (reps, d), is one, as in the reference)
            if weight_decay and p.ndim >= 2:
                delta.add_(p32, alpha=weight_decay)
            _store(p, p32.sub_(delta.mul_(lr)))
            _store(m, m_new)
            _store(v, v_new)

        map_tree(upd, grads, state["m"], state["v"], params)
        return params, state

    return Optimizer(init, update, "adamw")


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum — Shazeer & Stern 2018)
# ---------------------------------------------------------------------------
def adafactor(lr_fn, *, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored for >=2-D leaves (row/col mean of squares over the last two
    axes), full second moment for 1-D.  State is O(n+m) per matrix."""

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def st(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"s": map_tree(st, params), "count": _count0(params)}

    is_state = lambda x: isinstance(x, dict) and ("v" in x or "vr" in x)

    def own_mean(j, xs, dim, axis):
        return [x.mean() if dim is None else x.mean(dim) for x in xs]

    @torch.no_grad()
    def update_blocks(grads, states, params, mean=None, step=None):
        """The update of leaves held as blocks: ``grads``, ``states`` and
        ``params`` are lists with one tree a block (each tree holding its
        block of every leaf, on its device).  ``mean(j, xs, dim, axis)``
        gives, for leaf ``j``, each block's mean of ``xs`` over the whole
        leaf along the parameter's ``axis`` (-1 or -2; None: every axis),
        ``xs`` being reduced along their ``dim``; the default is each
        block's own mean (the block is the whole leaf)."""
        mean = mean or own_mean
        lrs, betas = [], []
        for st in states:
            count = st["count"].add_(1)
            lrs.append(lr_fn(count if step is None else step))
            betas.append(1.0 - count.float() ** (-decay))
        sflat = [leaves(st["s"], is_leaf=is_state) for st in states]
        gflat = [leaves(g) for g in grads]
        pflat = [leaves(p) for p in params]
        for j in range(len(pflat[0])):
            ss = [f[j] for f in sflat]
            ps = [f[j] for f in pflat]
            g32 = [f[j].float() for f in gflat]
            g2 = [g * g + eps for g in g32]
            if _factored(ps[0]):
                vr = [b * s["vr"] + (1 - b) * r for b, s, r in
                      zip(betas, ss, mean(j, g2, -1, -1))]
                vc = [b * s["vc"] + (1 - b) * c for b, s, c in
                      zip(betas, ss, mean(j, g2, -2, -2))]
                # rank-1 reconstruction of 1/sqrt(v); vr's last axis is
                # the parameter's axis -2
                u = [g * torch.rsqrt(r / torch.clamp(m[..., None], min=eps)
                                     )[..., None]
                     * torch.rsqrt(c)[..., None, :]
                     for g, r, m, c in zip(g32, vr, mean(j, vr, -1, -2), vc)]
                for s, r, c in zip(ss, vr, vc):
                    s["vr"].copy_(r)
                    s["vc"].copy_(c)
            else:
                v = [b * s["v"] + (1 - b) * x
                     for b, s, x in zip(betas, ss, g2)]
                u = [g * torch.rsqrt(x) for g, x in zip(g32, v)]
                for s, x in zip(ss, v):
                    s["v"].copy_(x)
            # update clipping (RMS of the whole leaf's update <= threshold)
            ms = mean(j, [x * x for x in u], None, None)
            for p, x, m, lr in zip(ps, u, ms, lrs):
                x = x / torch.clamp(torch.sqrt(m) / clip_threshold, min=1.0)
                p32 = p.float()
                p_new = p32 - lr * x
                if weight_decay and p.ndim >= 2:
                    p_new = p_new - lr * weight_decay * p32
                p.copy_(p_new)

    def update(grads, state, params, step=None):
        update_blocks([grads], [state], [params], step=step)
        return params, state

    return Optimizer(init, update, "adafactor", update_blocks)


def make_optimizer(cfg, lr_fn) -> Optimizer:
    """Config-driven optimizer choice (``cfg.optimizer`` /
    ``cfg.opt_state_dtype``)."""
    kind = getattr(cfg, "optimizer", "adamw")
    if kind == "adamw":
        return adamw(lr_fn, state_dtype=getattr(torch, cfg.opt_state_dtype))
    if kind == "adafactor":
        return adafactor(lr_fn)
    raise ValueError(kind)


__all__ = ["Optimizer", "adamw", "adafactor", "make_optimizer"]
