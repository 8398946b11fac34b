"""Griffin/RecurrentGemma recurrent block: temporal conv + RG-LRU, the
port of the reference's ``repro.models.rglru``.

The temporal conv (width ``cfg.conv_width``, depthwise, causal) is the
TINA depthwise FIR at the config's lowering, except that ``kernel`` runs
it ``native``, as the reference's ``pallas`` does: no FIR kernel serves
the models' short convs.  The RG-LRU is the elementwise linear
recurrence h_t = a_t·h_{t-1} + b_t: prefill runs it as a log-depth
Hillis–Steele scan (⌈log2 S⌉ doubling steps, the reference's
``lax.associative_scan`` in another association), decode as one step.

A state (:func:`init_rglru_state`) is written in place: prefill leaves
the last h (f32) and the last ``conv_width - 1`` inputs of the conv
(compute dtype) in it for decode to continue from.
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
_C = 8.0  # RG-LRU exponent scale (Griffin)
LINEARS = ("in_x", "in_gate", "w_r", "w_i", "out")


def fir_lowering(cfg: ModelConfig) -> str:
    """The depthwise FIR's lowering for the models' convs: the config's,
    with ``kernel`` read as ``native`` (the reference's ``pallas`` ->
    ``native``)."""
    return "native" if cfg.tina_lowering == "kernel" else cfg.tina_lowering


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    lru = cfg.lru_width or d
    pd = layers.pdtype(cfg)
    # Λ so that a = sigmoid(Λ)^c lies in (0.9, 0.999): Griffin's appendix
    u = torch.rand((lru,), generator=gen, device=gen.device) * 0.099 + 0.9
    root = u ** (1.0 / _C)
    lam = torch.log(root / (1 - root))
    return {
        "in_x": layers.init_linear(gen, d, lru, cfg),
        "in_gate": layers.init_linear(gen, d, lru, cfg),
        "conv_taps": torch.randn((cfg.conv_width, lru), generator=gen,
                                 device=gen.device, dtype=pd) * 0.1,
        "w_r": layers.init_linear(gen, lru, lru, cfg),
        "w_i": layers.init_linear(gen, lru, lru, cfg),
        "lambda": lam.to(pd),
        "out": layers.init_linear(gen, lru, d, cfg, scale=lru ** -0.5),
    }


def _gates(p: Params, u: Tensor, cfg: ModelConfig) -> tuple[Tensor, Tensor]:
    r = torch.sigmoid(layers.linear(p["w_r"], u, cfg).float())
    i = torch.sigmoid(layers.linear(p["w_i"], u, cfg).float())
    log_a = -_C * r * F.softplus(p["lambda"].float())
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * u.float())
    return a, b


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t·h_{t-1} + b_t along axis 1 from h_{-1} = 0, by
    Hillis–Steele doubling: after the step of distance d, element t holds
    the composition of elements t-2d+1..t."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def rglru_block(p: Params, x: Tensor, cfg: ModelConfig, *,
                state: Optional[dict] = None
                ) -> tuple[Tensor, Optional[dict]]:
    """x: (B, S, d).  ``state`` ({"h": (B, lru) f32, "conv": (B, w-1,
    lru)}) is filled by a prefill (S > 1) and advanced by a decode step
    (S == 1), in place; it is returned."""
    gate = F.gelu(layers.linear(p["in_gate"], x, cfg), approximate="tanh")
    xb = layers.linear(p["in_x"], x, cfg)                  # (B, S, lru)
    taps = p["conv_taps"].to(xb.dtype)
    w = taps.shape[0]

    if state is None or x.shape[1] > 1:
        # prefill: the TINA depthwise FIR, causal, then the scan
        u = tina.depthwise_fir(xb, taps, causal=True,
                               lowering=fir_lowering(cfg))
        a, b = _gates(p, u, cfg)
        h = linear_scan(a, b)
        if state is not None:
            state["h"].copy_(h[:, -1])
            state["conv"].copy_(xb[:, -(w - 1):])
        h = h.to(x.dtype)
    else:
        # decode: one step of the conv and of the recurrence
        window = torch.cat([state["conv"], xb], 1)          # (B, w, lru)
        u = torch.einsum("bwl,wl->bl", window, taps)[:, None]
        a, b = _gates(p, u, cfg)
        h = a[:, 0] * state["h"] + b[:, 0]                  # (B, lru)
        state["h"].copy_(h)
        state["conv"].copy_(window[:, 1:])
        h = h[:, None].to(x.dtype)

    return layers.linear(p["out"], h * gate, cfg), state


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    lru = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, lru), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, lru),
                            dtype=layers.cdtype(cfg), device=device),
    }


__all__ = ["init_rglru_block", "rglru_block", "init_rglru_state",
           "linear_scan", "fir_lowering", "LINEARS"]
