"""Shared neural layers of the model zoo's dense decoders: the port of the
reference's ``repro.models.layers``.

Every matmul routes through the TINA pointwise-conv mapping
(:func:`repro_torch.core.functions.matmul`); ``cfg.tina_lowering``
selects the lowering: ``native`` (``torch.matmul``), ``conv`` (the
paper-faithful NN layer) or ``kernel`` (the hand-written GEMM kernels of
:mod:`repro_torch.kernels.matmul`: bf16 at bf16 compute, 3xTF32 at f32).

Parameters are plain dicts of tensors in the reference's layout (a
linear's ``w`` is (d_in, d_out)).  The reference casts each f32 weight
to the compute dtype on every call; :func:`prepare` makes that cast once
instead, as the weights' K-major copy (``wt``, (d_out, d_in)), which the
bf16 kernel reads as its B operand and the other lowerings read through
its transpose: the same values, made once.  The sharding constraints of
the reference drop out: on one device they are no-ops.

Numerics kept from the reference: norms in f32, cast back; rope's cos
and sin cast to x's dtype and the rotation done in it; attention scores,
softmax and the value sums in f32; an untied head's f32 activations
against the head weight rounded through the compute dtype; a tied head
in f32 against the f32 table.

Caches are dicts of preallocated tensors written in place, and their
``pos`` (tokens so far) is a host int, so no layer reads a device scalar
back.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import functions as tina
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = dict


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# linear / dense through TINA
# ---------------------------------------------------------------------------
def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                cfg: ModelConfig, *, bias: bool = False,
                scale: float | None = None) -> Params:
    scale = (d_in ** -0.5) if scale is None else scale
    p = {"w": torch.randn((d_in, d_out), generator=gen, device=gen.device,
                          dtype=pdtype(cfg)) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), device=gen.device, dtype=pdtype(cfg))
    return p


def prepare_linear(p: Params, cfg: ModelConfig) -> Params:
    """``p`` with ``wt``: the weight cast to the compute dtype once, as
    its K-major copy (d_out, d_in), where the compute dtype is not the
    f32 the f32 GEMM reads as it is."""
    if cdtype(cfg) == torch.float32 or "wt" in p:
        return p
    return {**p, "wt": p["w"].t().contiguous().to(cdtype(cfg))}


def linear(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    cd = cdtype(cfg)
    wt = p.get("wt")
    if wt is not None and wt.dtype == cd:
        w = wt.t()                   # (d_in, d_out), the copy made once
    else:
        w, wt = p["w"].to(cd), None
    if cfg.use_tina:
        shape = x.shape[:-1]
        out = tina.matmul(x.reshape((-1, x.shape[-1])), w,
                          lowering=cfg.tina_lowering, yt=wt)
        out = out.reshape(shape + (w.shape[1],))
    else:
        # jnp.matmul promotes mixed operands (an untied head: f32 x
        # against the weight rounded through the compute dtype)
        dt = torch.promote_types(x.dtype, w.dtype)
        wr = p.get("wr")
        w = wr if wr is not None and dt == torch.float32 else w.to(dt)
        out = torch.matmul(x.to(dt), w)
    if "b" in p:
        out = out + p["b"].to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(cfg: ModelConfig, device, d: int | None = None) -> Params:
    d = d or cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones((d,), device=device, dtype=pdtype(cfg))}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones((d,), device=device, dtype=pdtype(cfg)),
                "bias": torch.zeros((d,), device=device, dtype=pdtype(cfg))}
    if cfg.norm_type == "nonparam_ln":       # OLMo: no affine params
        return {}
    raise ValueError(cfg.norm_type)


def norm(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    x32 = x.float()
    if cfg.norm_type == "rmsnorm":
        y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
        y = y * p["scale"].float()
    else:
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + 1e-5)
        if "scale" in p:
            y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embedding (partial fraction supported -- stablelm)
# ---------------------------------------------------------------------------
def rope_angles(positions: Tensor, cfg: ModelConfig
                ) -> Optional[tuple[Tensor, Tensor]]:
    """(cos, sin) in f32, each (B, S, 1, rotary_dim / 2), of positions
    (B, S); None where the config rotates nothing.  A forward computes
    them once for all its layers."""
    rd = cfg.rotary_dim
    if rd == 0:
        return None
    half = rd // 2
    freqs = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half)
    ang = positions[..., None].float() * freqs              # (B, S, half)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rope(x: Tensor, positions: Tensor, cfg: ModelConfig, *,
         angles: Optional[tuple[Tensor, Tensor]] = None) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S) absolute positions.
    ``angles``: :func:`rope_angles` of positions, where made already."""
    rd = cfg.rotary_dim
    if rd == 0:
        return x
    cos, sin = rope_angles(positions, cfg) if angles is None else angles
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    half = rd // 2
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., :half], xr[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([rot, xp], -1) if rd < x.shape[-1] else rot


# ---------------------------------------------------------------------------
# attention (GQA, causal / bidirectional / sliding window, KV cache)
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": init_linear(gen, d, h * hd, cfg, bias=cfg.qkv_bias),
        "wk": init_linear(gen, d, hkv * hd, cfg, bias=cfg.qkv_bias),
        "wv": init_linear(gen, d, hkv * hd, cfg, bias=cfg.qkv_bias),
        "wo": init_linear(gen, h * hd, d, cfg, scale=(h * hd) ** -0.5),
    }


def _online_softmax_attn(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                         window: int, chunk: int, q_offset: int,
                         kv_len: Optional[int] = None) -> Tensor:
    """Flash-pattern chunked attention: a loop over KV chunks with a
    running (max, denom, acc).  q: (B,Sq,H,hd); k/v: (B,Skv,Hkv,hd).
    ``kv_len`` masks positions >= kv_len."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    ck = min(chunk, skv)
    nchunk = -(-skv // ck)
    pad = nchunk * ck - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kc = k.reshape(b, nchunk, ck, hkv, hd)
    vc = v.reshape(b, nchunk, ck, hkv, hd)
    scale = hd ** -0.5
    dev = q.device
    qpos = q_offset + torch.arange(sq, device=dev)              # (Sq,)
    qh = (q * scale).reshape(b, sq, hkv, rep, hd).float()

    m = torch.full((b, hkv, rep, sq), -torch.inf, device=dev)
    l = torch.zeros((b, hkv, rep, sq), device=dev)
    acc = torch.zeros((b, hkv, rep, sq, hd), device=dev)
    for j in range(nchunk):
        kvpos = j * ck + torch.arange(ck, device=dev)           # (Ck,)
        s = torch.einsum("bsgrd,bcgd->bgrsc", qh, kc[:, j].float())
        valid = (kvpos < skv)[None, :]
        if kv_len is not None:
            valid = valid & (kvpos < kv_len)[None, :]
        if causal:
            valid = valid & (kvpos[None, :] <= qpos[:, None])
        if window:
            valid = valid & (qpos[:, None] - kvpos[None, :] < window)
        s = torch.where(valid, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))                    # (B,G,rep,Sq)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrsc,bcgd->bgrsd", p, vc[:, j].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def attention(p: Params, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
              pos0: int = 0, cache: Optional[dict] = None, window: int = 0,
              angles: Optional[tuple[Tensor, Tensor]] = None
              ) -> tuple[Tensor, Optional[dict]]:
    """x: (B, S, D); ``pos0`` is positions[0, 0] on the host.  Training /
    prefill when cache is None or being filled; single-token decode when
    x.shape[1] == 1 and cache is given.  A cache is written in place and
    returned."""
    b, s, _ = x.shape
    q, k, v = qkv(p, x, cfg, positions=positions, angles=angles)
    decode_pos = None
    if cache is not None:
        k, v, decode_pos = write_cache(cache, k, v)
    out = attend(q, k, v, cfg, window=window,
                 q_offset=pos0 if cache is not None else 0,
                 decode_pos=decode_pos)
    return linear(p["wo"], out.reshape(b, s, -1), cfg), cache


def qkv(p: Params, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
        angles: Optional[tuple[Tensor, Tensor]] = None
        ) -> tuple[Tensor, Tensor, Tensor]:
    """x's (B, S, D) rope'd q (B, S, H, hd) and k, and v (B, S, Hkv,
    hd)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(p["wq"], x, cfg).reshape(b, s, h, hd)
    k = linear(p["wk"], x, cfg).reshape(b, s, hkv, hd)
    v = linear(p["wv"], x, cfg).reshape(b, s, hkv, hd)
    return (rope(q, positions, cfg, angles=angles),
            rope(k, positions, cfg, angles=angles), v)


def write_cache(cache: dict, k: Tensor, v: Tensor
                ) -> tuple[Tensor, Tensor, Optional[int]]:
    """Writes rope'd k / v (B, S, Hkv, hd) into ``cache`` in place: one
    token (decode) at the rolling slot pos % size (rolling == plain write
    while pos < size, which covers full-cache decode too), a prefill's
    (window-)tail from slot 0.  Returns what attention reads: a decode's
    whole cache and its token's position, or a prefill's k, v and None."""
    size, pos = cache["k"].shape[1], cache["pos"]      # host int: so far
    s = k.shape[1]
    cache["pos"] = pos + s
    if s == 1:
        idx = pos % size
        cache["k"][:, idx] = k[:, 0]
        cache["v"][:, idx] = v[:, 0]
        return cache["k"], cache["v"], pos
    kk, vv = (k[:, -size:], v[:, -size:]) if s > size else (k, v)
    cache["k"][:, :kk.shape[1]] = kk.to(cache["k"].dtype)
    cache["v"][:, :vv.shape[1]] = vv.to(cache["v"].dtype)
    return k, v, None


def attend(q: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig, *,
           window: int = 0, q_offset: int = 0,
           decode_pos: Optional[int] = None) -> Tensor:
    """Attention of rope'd q (B, S, H, hd) over k / v (B, Skv, Hkv, hd):
    one token at ``decode_pos`` against a (rolling) cache, else the
    chunked online softmax, the queries from position ``q_offset``."""
    if decode_pos is not None:
        return _decode_attn(q, k, v, pos=decode_pos, size=k.shape[1],
                            window=window)
    return _online_softmax_attn(q, k, v, causal=cfg.causal, window=window,
                                chunk=cfg.attn_chunk, q_offset=q_offset)


def _decode_attn(q: Tensor, ck: Tensor, cv: Tensor, *, pos: int, size: int,
                 window: int) -> Tensor:
    """One-token attention against a (possibly rolling) cache.
    q: (B,1,H,hd); ck/cv: (B,size,Hkv,hd); pos: the token's position."""
    b, _, h, hd = q.shape
    hkv = ck.shape[2]
    rep = h // hkv
    qh = q[:, 0].reshape(b, hkv, rep, hd) * hd ** -0.5
    s = torch.einsum("bgrd,bcgd->bgrc", qh.float(), ck.float())
    slot = torch.arange(size, device=q.device)
    # slot c holds absolute position pos - ((pos % size - c) % size): the
    # latest `size` tokens of a rolling buffer
    n_written = min(pos + 1, size)
    abs_pos = pos - torch.remainder(pos % size - slot, size)
    valid = (abs_pos >= max(0, pos + 1 - n_written)) & (abs_pos <= pos)
    if window:
        valid = valid & (pos - abs_pos < window)
    s = torch.where(valid, s, -1e30)
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrc,bcgd->bgrd", prob, cv.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def init_cache(cfg: ModelConfig, batch: int, size: int, window: int = 0, *,
               device=None) -> dict:
    eff = min(size, window) if window else size
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, eff, hkv, hd), device=device,
                         dtype=cdtype(cfg)),
        "v": torch.zeros((batch, eff, hkv, hd), device=device,
                         dtype=cdtype(cfg)),
        "pos": 0,
    }


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    p = {"up": init_linear(gen, cfg.d_model, d_ff, cfg),
         "down": init_linear(gen, d_ff, cfg.d_model, cfg, scale=d_ff ** -0.5)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["gate"] = init_linear(gen, cfg.d_model, d_ff, cfg)
    return p


def mlp(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    up = linear(p["up"], x, cfg)
    if cfg.mlp_type == "swiglu":
        act = F.silu(linear(p["gate"], x, cfg)) * up
    elif cfg.mlp_type == "geglu":
        act = F.gelu(linear(p["gate"], x, cfg), approximate="tanh") * up
    elif cfg.mlp_type == "gelu":
        act = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    else:
        raise ValueError(cfg.mlp_type)
    return linear(p["down"], act, cfg)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------
def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"table": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                                 device=gen.device, dtype=pdtype(cfg)) * 0.02}


def embed(p: Params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    # the reference casts the whole table, then gathers: the same values
    return p["table"][tokens].to(cdtype(cfg))


def unembed(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Logits in f32 (softmax stability)."""
    return torch.matmul(x.float(), p["table"].float().t())
