"""RWKV6 "Finch": attention-free time mix with data-dependent decay, the
port of the reference's ``repro.models.rwkv6``.

Token shift is a 2-tap causal FIR: the TINA depthwise FIR at the
``conv`` lowering, a pad and a slice otherwise.  The WKV6 recurrence is
a data-dependent scan, which TINA scopes out: a plain loop over the
sequence carrying the (B, H, hs, hs) f32 state, in the reference's
``lax.scan`` order, step for step.

A state (:func:`init_rwkv_state`) is written in place: the time mix
leaves the WKV state ``S`` and its last input ``x_tm``, the channel mix
its last input ``x_cm``, for the next call to continue from.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import functions as tina
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = dict
TIME_MIX_LINEARS = ("wr", "wk", "wv", "wg", "wo")
CHANNEL_MIX_LINEARS = ("wk", "wv", "wr")


def _shift(x: Tensor, cfg: ModelConfig, prev: Optional[Tensor] = None
           ) -> Tensor:
    """x[t] -> x[t-1]: zero at t = 0, or ``prev`` to continue a state."""
    if cfg.use_tina and cfg.tina_lowering == "conv":
        taps = torch.zeros((2, x.shape[-1]), dtype=x.dtype, device=x.device)
        taps[1] = 1.0
        out = tina.depthwise_fir(x, taps, causal=True, lowering="conv")
    else:
        out = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if prev is not None:
        out[:, 0] = prev.to(out.dtype)
    return out


def init_time_mix(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    h = d // hs
    r = cfg.rwkv_lora_rank
    pd = layers.pdtype(cfg)

    def nrm(shape, scale):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=pd) * scale

    return {
        "mu_base": nrm((d,), 0.02),
        "mu_rwkvg": nrm((5, d), 0.02),
        "mix_w1": nrm((d, 5 * r), d ** -0.5),
        "mix_w2": nrm((5, r, d), r ** -0.5),
        "w0": nrm((d,), 0.02) - 6.0,    # decay bias: slow by default
        "td_w1": nrm((d, 2 * r), d ** -0.5),
        "td_w2": nrm((2 * r, d), (2 * r) ** -0.5),
        "u": nrm((h, hs), 0.02),
        "wr": layers.init_linear(gen, d, d, cfg),
        "wk": layers.init_linear(gen, d, d, cfg),
        "wv": layers.init_linear(gen, d, d, cfg),
        "wg": layers.init_linear(gen, d, d, cfg),
        "wo": layers.init_linear(gen, d, d, cfg, scale=d ** -0.5),
        "ln_x": torch.ones((d,), dtype=pd, device=gen.device),
    }


def _ddlerp(p: Params, x: Tensor, xx: Tensor) -> tuple[Tensor, ...]:
    """RWKV6 data-dependent lerp: the mixed inputs of r, w, k, v, g."""
    mu = p["mu_base"].to(x.dtype)
    xxx = x + xx * mu
    lo = torch.tanh(xxx @ p["mix_w1"].to(x.dtype))          # (B, S, 5r)
    lo = lo.reshape(*lo.shape[:-1], 5, -1)                  # (B, S, 5, r)
    delta = torch.einsum("bsfr,frd->bsfd", lo, p["mix_w2"].to(x.dtype))
    mus = p["mu_rwkvg"].to(x.dtype)                         # (5, d)
    mixed = x[..., None, :] + xx[..., None, :] * (mus + delta)
    return tuple(mixed[..., i, :] for i in range(5))


def _wkv_scan(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
              state: Tensor) -> tuple[Tensor, Tensor]:
    """r/k/v/w: (B, S, H, hs) f32; u: (H, hs); state: (B, H, hs, hs).
    Returns out (B, S, H, hs) and the final state (a new tensor)."""
    s = state
    uk = u[None] * k                                        # (B, S, H, hs)
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        out = torch.einsum("bhi,bhij->bhj", rt, s)
        bonus = torch.einsum("bhi,bhi->bh", rt, uk[:, t])
        outs.append(out + bonus[..., None] * vt)
        s = wt[..., None] * s + kt[..., None] * vt[..., None, :]
    return torch.stack(outs, 1), s


def time_mix(p: Params, x: Tensor, cfg: ModelConfig, *,
             state: Optional[dict] = None) -> tuple[Tensor, Optional[dict]]:
    b, s, d = x.shape
    hs = cfg.rwkv_head_size
    h = d // hs
    prev = state["x_tm"] if state is not None else None
    xx = _shift(x, cfg, prev) - x
    xr, xw, xk, xv, xg = _ddlerp(p, x, xx)

    r = layers.linear(p["wr"], xr, cfg).reshape(b, s, h, hs).float()
    k = layers.linear(p["wk"], xk, cfg).reshape(b, s, h, hs).float()
    v = layers.linear(p["wv"], xv, cfg).reshape(b, s, h, hs).float()
    g = F.silu(layers.linear(p["wg"], xg, cfg))

    # data-dependent decay w_t = exp(-exp(w0 + lora(x_w))) in (0, 1)
    td = torch.tanh(xw @ p["td_w1"].to(x.dtype))
    wlog = p["w0"].float() + td.float() @ p["td_w2"].float()
    w = torch.exp(-torch.exp(wlog)).reshape(b, s, h, hs)

    s0 = state["S"] if state is not None else torch.zeros(
        (b, h, hs, hs), dtype=torch.float32, device=x.device)
    out, s_new = _wkv_scan(r, k, v, w, p["u"].float(), s0)

    # per-head group norm (ln_x, population variance), gate, project out
    mu = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, unbiased=False)
    out = (out - mu) * torch.rsqrt(var + 1e-5)
    out = out.reshape(b, s, d) * p["ln_x"].float()
    out = out.to(x.dtype) * g
    if state is not None:
        state["S"].copy_(s_new)
        state["x_tm"].copy_(x[:, -1])
    return layers.linear(p["wo"], out, cfg), state


def init_channel_mix(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    pd = layers.pdtype(cfg)
    return {
        "mu_k": torch.randn((d,), generator=gen, device=gen.device,
                            dtype=pd) * 0.02,
        "mu_r": torch.randn((d,), generator=gen, device=gen.device,
                            dtype=pd) * 0.02,
        "wk": layers.init_linear(gen, d, f, cfg),
        "wv": layers.init_linear(gen, f, d, cfg, scale=f ** -0.5),
        "wr": layers.init_linear(gen, d, d, cfg),
    }


def channel_mix(p: Params, x: Tensor, cfg: ModelConfig, *,
                state: Optional[dict] = None
                ) -> tuple[Tensor, Optional[dict]]:
    prev = state["x_cm"] if state is not None else None
    xx = _shift(x, cfg, prev) - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    kk = torch.square(F.relu(layers.linear(p["wk"], xk, cfg)))
    out = torch.sigmoid(layers.linear(p["wr"], xr, cfg)) \
        * layers.linear(p["wv"], kk, cfg)
    if state is not None:
        state["x_cm"].copy_(x[:, -1])
    return out, state


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    h = d // hs
    return {
        "S": torch.zeros((batch, h, hs, hs), dtype=torch.float32,
                         device=device),
        "x_tm": torch.zeros((batch, d), dtype=layers.cdtype(cfg),
                            device=device),
        "x_cm": torch.zeros((batch, d), dtype=layers.cdtype(cfg),
                            device=device),
    }


__all__ = ["init_time_mix", "time_mix", "init_channel_mix", "channel_mix",
           "init_rwkv_state", "TIME_MIX_LINEARS", "CHANNEL_MIX_LINEARS"]
