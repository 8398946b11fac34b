"""Mixture-of-Experts block (kimi-k2, arctic): the port of the reference's
``repro.models.moe`` on its GSPMD path, the one it takes whenever no
mesh rule is active.

Sort-based fixed-capacity token dispatch: top-k routing, the (token,
expert) assignments flattened token-major and sorted by expert, each
one's slot within its expert from the counts' exclusive prefix sum, the
kept ones scattered into a dense (E, C, d) buffer, batched expert
products, and each token's weighted contributions summed back.  The
expert products are plain batched matmuls, as the reference leaves them
to ``jnp.einsum`` outside any kernel; the shared expert (kimi) and the
dense residual MLP (arctic) are ``layers.mlp`` and so go through the
TINA matmul.

Three orders decide which tokens are kept and what they sum to, and each
is explicit here:

- the top-k: the first k of a stable descending sort of the router's
  probabilities, so equal probabilities go to the lower expert index,
  as ``jax.lax.top_k`` does (``torch.topk`` promises no order among
  equals);
- the dispatch: a stable argsort of the experts in token-major order,
  as ``jnp.argsort``, so an overfull expert keeps its earliest tokens;
- the combine: each token's k contributions gathered back into (token,
  k) order through the inverse of the sort and added in ascending k,
  not ``index_add_`` (atomics on the card, whose order changes from run
  to run).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = dict
EXPERT_WEIGHTS = ("w_up", "w_gate", "w_down")


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    pd = layers.pdtype(cfg)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=pd).mul_(scale)

    p = {"router": {"w": normal((d, e), d ** -0.5)},
         "w_up": normal((e, d, f), d ** -0.5),
         "w_gate": normal((e, d, f), d ** -0.5),
         "w_down": normal((e, f, d), f ** -0.5)}
    if cfg.shared_experts:
        p["shared"] = layers.init_mlp(gen, cfg,
                                      d_ff=cfg.d_ff * cfg.shared_experts)
    if cfg.dense_residual_ff:
        p["dense"] = layers.init_mlp(gen, cfg, d_ff=cfg.dense_residual_ff)
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens: the
    reference's ``_capacity``, rounded up to 8 and at least 8.  A prefill
    and a decode step of one model therefore differ in capacity."""
    k, e = cfg.n_experts_per_token, cfg.n_experts
    c = int(n_tokens * k / e * cfg.moe_capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """(gate values, experts), each (N, k): the k largest probabilities
    of each row in descending order, ties to the lower expert index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_block(p: Params, x: Tensor, cfg: ModelConfig
              ) -> tuple[Tensor, dict]:
    """x: (B, S, d) -> (B, S, d), and the reference's aux metrics
    (``moe_aux_loss``, ``moe_drop_frac``), plus, for callers that compare
    routings, ``moe_experts``: the chosen experts (B·S, k), and
    ``moe_kept``: which of them kept the token (B·S, k)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    n = b * s
    dev = x.device
    xt = x.reshape(n, d)

    # routing, in f32
    logits = xt.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, -1)
    gate_vals, experts = route(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # switch-style load-balance loss; the counts are integer sums (exact
    # in any order), and no host sync, unlike bincount on the card
    flat_e = experts.reshape(-1)                            # (N*k,)
    counts = torch.zeros(e, dtype=flat_e.dtype, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    frac_tokens = counts.float() / (n * k)
    aux_loss = e * torch.sum(frac_tokens * probs.mean(0))

    # sort-based dispatch
    cap = capacity(n, cfg)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.cumsum(counts, 0) - counts               # exclusive
    pos = torch.arange(n * k, device=dev) - starts[se]      # slot in expert
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)       # drops: trash row
    st = order // k                                         # token of each
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xt[st]                 # kept slots are distinct; drops land
    buf = buf[: e * cap].view(e, cap, d)   # on the trash row, cut off here

    # expert FFNs, batched over E
    cd = layers.cdtype(cfg)
    up = torch.bmm(buf, p["w_up"].to(cd))
    gate = torch.bmm(buf, p["w_gate"].to(cd))
    out = torch.bmm(F.silu(gate) * up, p["w_down"].to(cd))

    # combine: back to (token, k) order, summed in ascending k
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=dev)
    out_flat = torch.cat([out.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=out.dtype, device=dev)])
    kept = keep[inv]
    contrib = (out_flat[slot[inv]]
               * gate_vals.reshape(-1, 1).to(out.dtype)
               * kept[:, None].to(out.dtype)).view(n, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    y = y.reshape(b, s, d)

    # the kept share as XLA computes the reference's keep.mean(): the
    # count times the f32 reciprocal of N*k, so the two agree bit for bit
    dropped = 1.0 - keep.sum().float() * (1.0 / (n * k))
    if cfg.shared_experts:
        y = y + layers.mlp(p["shared"], x, cfg)
    if cfg.dense_residual_ff:
        y = y + layers.mlp(p["dense"], x, cfg)
    return y, {"moe_aux_loss": aux_loss, "moe_drop_frac": dropped,
               "moe_experts": experts, "moe_kept": kept.view(n, k)}


__all__ = ["init_moe", "capacity", "route", "moe_block", "EXPERT_WEIGHTS"]
