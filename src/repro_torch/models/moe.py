"""Mixture-of-Experts block (kimi-k2, arctic): the port of the reference's
``repro.models.moe``.  :func:`moe_block` is its GSPMD path on one
device; :func:`routed` runs the routed experts of one expert group, the
piece both of its dispatches over a mesh are made of
(:func:`repro_torch.models.sharded.moe_block`).

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
    n, k = b * s, cfg.n_experts_per_token
    y, st = routed(p, x.reshape(n, d), cfg, lo=0, n_local=cfg.n_experts)
    y = y.reshape(b, s, d)
    # the kept share as XLA computes the reference's keep.mean(): the
    # count times the f32 reciprocal of N*k, so the two agree bit for bit
    dropped = 1.0 - st["kept"] * (1.0 / (n * k))
    if cfg.shared_experts:
        y = y + layers.mlp(p["shared"], x, cfg)
    if cfg.dense_residual_ff:
        y = y + layers.mlp(p["dense"], x, cfg)
    return y, {"moe_aux_loss": st["aux_loss"], "moe_drop_frac": dropped,
               "moe_experts": st["experts"], "moe_kept": st["kept_mask"]}


def routed(p: Params, xt: Tensor, cfg: ModelConfig, *, lo: int,
           n_local: int, router_in_x_dtype: bool = False
           ) -> tuple[Tensor, dict]:
    """The routed experts' output for tokens ``xt`` (N, d), from experts
    [lo, lo + n_local) only: ``p``'s expert weights are that group's
    (all of them for lo = 0, n_local = E, :func:`moe_block`; one model
    shard's under expert parallelism, whose partial outputs sum over the
    shards).  Every token is routed over all E experts; the dispatch
    sorts the group's assignments alone (the rest to a trash slot at
    ``n_local``), which keeps the same tokens as a sort over all experts:
    a token's slot within its expert counts that expert's earlier
    assignments only.  ``router_in_x_dtype``: the router product in
    ``xt``'s dtype, then f32 (the reference's ``shard_map`` body), not in
    f32.  Stats: ``aux_loss`` (of all the tokens' routing), ``kept`` and
    ``assigned`` (the group's assignments kept and made, f32 counts),
    ``experts`` and ``kept_mask`` ((N, k): an assignment outside the
    group is not kept here)."""
    n, d = xt.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    dev = xt.device

    # routing, in f32
    w = p["router"]["w"]
    if router_in_x_dtype:
        logits = (xt @ w.to(xt.dtype)).float()
    else:
        logits = xt.float() @ w.float()
    probs = torch.softmax(logits, -1)
    gate_vals, experts = route(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # switch-style load-balance loss; the counts are integer sums (exact
    # in any order), and no host sync, unlike bincount on the card
    flat_e = experts.reshape(-1)                            # (N*k,)
    ones = torch.ones_like(flat_e)
    counts = torch.zeros(e, dtype=flat_e.dtype, device=dev).scatter_add_(
        0, flat_e, ones)
    frac_tokens = counts.float() / (n * k)
    aux_loss = e * torch.sum(frac_tokens * probs.mean(0))

    # sort-based dispatch over the group; the rest go to slot n_local
    cap = capacity(n, cfg)
    local = (flat_e >= lo) & (flat_e < lo + n_local)
    le = torch.where(local, flat_e - lo, n_local)
    lcounts = torch.zeros(n_local + 1, dtype=le.dtype,
                          device=dev).scatter_add_(0, le, ones)
    order = torch.argsort(le, stable=True)
    se = le[order]
    starts = torch.cumsum(lcounts, 0) - lcounts             # exclusive
    pos = torch.arange(n * k, device=dev) - starts[se]      # slot in expert
    keep = (pos < cap) & (se < n_local)
    slot = torch.where(keep, se * cap + pos, n_local * cap)  # trash row
    st = order // k                                         # token of each
    buf = torch.zeros((n_local * cap + 1, d), dtype=xt.dtype, device=dev)
    buf[slot] = xt[st]                 # kept slots are distinct; the rest
    buf = buf[: n_local * cap].view(n_local, cap, d)   # land on the trash
                                                       # row, cut off here
    # expert FFNs, batched over the group
    cd = layers.cdtype(cfg)
    up = torch.bmm(buf, p["w_up"].to(cd))
    gate = torch.bmm(buf, p["w_gate"].to(cd))
    out = torch.bmm(F.silu(gate) * up, p["w_down"].to(cd))

    # combine: back to (token, k) order, summed in ascending k
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=dev)
    out_flat = torch.cat([out.reshape(n_local * cap, d),
                          torch.zeros((1, d), dtype=out.dtype, device=dev)])
    kept = keep[inv]
    contrib = (out_flat[slot[inv]]
               * gate_vals.reshape(-1, 1).to(out.dtype)
               * kept[:, None].to(out.dtype)).view(n, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y, {"aux_loss": aux_loss, "kept": keep.sum().float(),
               "assigned": local.sum().float(), "experts": experts,
               "kept_mask": kept.view(n, k)}


__all__ = ["init_moe", "capacity", "route", "moe_block", "routed",
           "EXPERT_WEIGHTS"]
