"""RWKV6 "Finch": attention-free time mix with data-dependent decay, the
port of the reference's ``repro.models.rwkv6``.

Token shift is a 2-tap causal FIR: the TINA depthwise FIR at the
``conv`` lowering, a pad and a slice otherwise.  The WKV6 recurrence is
a data-dependent scan, which TINA scopes out; as the reference's one
``lax.scan`` it is one op, :func:`repro_torch.kernels.wkv.wkv6`, whatever
the lowering: on the CPU the plain loop over the sequence carrying the
(B, H, hs, hs) f32 state in the scan's order, step for step, on the card
a hand-written kernel (``csrc/wkv6.cu``) and its gradient, on meta one
dispatch with the loop's FLOPs.

A state (:func:`init_rwkv_state`) is written in place: the time mix
leaves the WKV state ``S`` and its last input ``x_tm``, the channel mix
its last input ``x_cm``, for the next call to continue from.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import functions as tina
from repro_torch.kernels import wkv
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
    return wkv.wkv6(r, k, v, w, u, state)


def mix_inputs(p: Params, x: Tensor, cfg: ModelConfig, prev: Optional[Tensor],
               cols: Optional[tuple[int, int]] = None) -> tuple[Tensor, ...]:
    """The time mix's projections of ``x`` after ``prev``: the outputs of
    the ``wr``/``wk``/``wv`` linears, ``silu`` of ``wg``'s, and the
    data-dependent decay ``w`` (f32) of the columns ``cols`` of the heads
    (None: all of ``w0``'s)."""
    xx = _shift(x, cfg, prev) - x
    xr, xw, xk, xv, xg = _ddlerp(p, x, xx)
    r = layers.linear(p["wr"], xr, cfg)
    k = layers.linear(p["wk"], xk, cfg)
    v = layers.linear(p["wv"], xv, cfg)
    g = F.silu(layers.linear(p["wg"], xg, cfg))

    # data-dependent decay w_t = exp(-exp(w0 + lora(x_w))) in (0, 1)
    w0, w2 = p["w0"], p["td_w2"]
    if cols is not None:
        w0, w2 = w0[cols[0]:cols[1]], w2[:, cols[0]:cols[1]]
    td = torch.tanh(xw @ p["td_w1"].to(x.dtype))
    wlog = w0.float() + td.float() @ w2.float()
    return r, k, v, g, torch.exp(-torch.exp(wlog))


def mix_heads(p: Params, r: Tensor, k: Tensor, v: Tensor, w: Tensor,
              g: Tensor, cfg: ModelConfig, s0: Optional[Tensor],
              dtype: torch.dtype, heads: Optional[tuple[int, int]] = None
              ) -> tuple[Tensor, Tensor]:
    """The WKV scan, per-head group norm and gate of heads ``heads`` (None:
    all of ``p["u"]``'s) from :func:`mix_inputs`' projections of those
    heads, from WKV state ``s0`` (None: zero): (gated output in
    ``dtype``, final state)."""
    b, s = r.shape[:2]
    hs = cfg.rwkv_head_size
    u, ln_x = p["u"], p["ln_x"]
    if heads is not None:
        u, ln_x = u[heads[0]:heads[1]], ln_x[heads[0] * hs:heads[1] * hs]
    h = u.shape[0]
    # the WKV op takes dense f32 blocks (the flat split's heads are a
    # column cut of the gathered projections)
    r = r.reshape(b, s, h, hs).float().contiguous()
    k = k.reshape(b, s, h, hs).float().contiguous()
    v = v.reshape(b, s, h, hs).float().contiguous()
    w = w.reshape(b, s, h, hs).contiguous()
    if s0 is None:
        s0 = torch.zeros((b, h, hs, hs), dtype=torch.float32,
                         device=r.device)
    out, s_new = _wkv_scan(r, k, v, w, u.float().contiguous(),
                           s0.contiguous())

    # per-head group norm (ln_x, population variance), gate
    mu = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, unbiased=False)
    out = (out - mu) * torch.rsqrt(var + 1e-5)
    out = out.reshape(b, s, h * hs) * ln_x.float()
    return out.to(dtype) * g, s_new


def mix_core(p: Params, x: Tensor, cfg: ModelConfig, prev: Optional[Tensor],
             s0: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    """The time mix of ``x`` after ``prev`` (the input before x[:, 0];
    None: zero) from WKV state ``s0`` (None: zero): (out, final state).
    The heads are ``p["u"]``'s: a block of them (a tensor-parallel
    shard's, whose ``wr``/``wk``/``wv``/``wg`` columns, ``wo`` rows and
    ``w0``/``td_w2``/``u``/``ln_x`` are cut to them) gives those heads'
    part of the output projection."""
    r, k, v, g, w = mix_inputs(p, x, cfg, prev)
    out, s_new = mix_heads(p, r, k, v, w, g, cfg, s0, x.dtype)
    return layers.linear(p["wo"], out, cfg), s_new


def time_mix(p: Params, x: Tensor, cfg: ModelConfig, *,
             state: Optional[dict] = None) -> tuple[Tensor, Optional[dict]]:
    if state is None:
        return mix_core(p, x, cfg, None, None)[0], None
    out, s_new = mix_core(p, x, cfg, state["x_tm"], state["S"])
    state["S"].copy_(s_new)
    state["x_tm"].copy_(x[:, -1])
    return out, state


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


__all__ = ["init_time_mix", "time_mix", "mix_core", "mix_inputs",
           "mix_heads", "init_channel_mix", "channel_mix",
           "init_rwkv_state", "TIME_MIX_LINEARS", "CHANNEL_MIX_LINEARS"]
