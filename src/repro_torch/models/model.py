"""Model assembly: one decoder/encoder covering all 10 assigned archs,
the port of the reference's ``repro.models.model``: forward, prefill
into caches, decode, and the training loss (:func:`loss_fn`).

The reference runs its layer stack as ``lax.scan`` over repeats of
``cfg.block_pattern``; here the stack is a plain loop over the repeats
(``params["stack"]``, one dict per repeat: the reference's vmapped tree
unstacked, see :mod:`repro_torch.models.convert`, whose training layout
hands the loop views of the stacked leaves) and then the unrolled tail.
Without caches, and with autograd on, the loop takes the reference's
remat: one ``torch.utils.checkpoint`` per superblock (``cfg.remat``), or
per group of ``cfg.remat_group`` superblocks (sqrt-remat, the remainder
per superblock).  Serving (caches given) runs the blocks as they are.

Blocks: ``attn`` (attention, then an MLP or, for ``cfg.moe``, the
:mod:`~repro_torch.models.moe` block), ``rglru``
(:mod:`~repro_torch.models.rglru`, then an MLP) and ``rwkv``
(:mod:`~repro_torch.models.rwkv6`'s time and channel mix).  Frontends
(stubs, as in the reference: precomputed features): ``vision_stub``
projects patch embeddings from 1024 and puts them before the tokens;
``audio_stub`` projects frames from 512 and adds a causal depthwise-FIR
positional embedding (width 128) through a tanh GELU.

Every block writes its cache in place (an attention cache's k/v and
counter, a recurrent state's tensors): :func:`init_caches` allocates
them once, and the returned caches are the same objects.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import functions as tina
from repro_torch.models import layers, moe, rglru, rwkv6
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = dict

VISION_FEAT_DIM = 1024   # InternViT output (stub)
AUDIO_FEAT_DIM = 512     # wav2vec2/HuBERT conv-extractor output (stub)
AUDIO_CONV_POS_WIDTH = 128
AUX_KEYS = ("moe_aux_loss", "moe_drop_frac")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    p: Params = {"ln1": layers.init_norm(cfg, gen.device),
                 "ln2": layers.init_norm(cfg, gen.device)}
    if kind == "attn":
        p["attn"] = layers.init_attention(gen, cfg)
        p["ffn"] = moe.init_moe(gen, cfg) if cfg.moe else \
            layers.init_mlp(gen, cfg)
    elif kind == "rglru":
        p["rec"] = rglru.init_rglru_block(gen, cfg)
        p["ffn"] = layers.init_mlp(gen, cfg)
    elif kind == "rwkv":
        p["tm"] = rwkv6.init_time_mix(gen, cfg)
        p["cm"] = rwkv6.init_channel_mix(gen, cfg)
    else:
        raise ValueError(kind)
    return p


def apply_block(p: Params, x: Tensor, cfg: ModelConfig, kind: str, *,
                positions: Tensor, pos0: int, cache: Optional[dict],
                angles=None) -> tuple[Tensor, Optional[dict], dict]:
    """(x, cache, aux): aux is the MoE block's, empty for other blocks."""
    aux: dict = {}
    if kind == "attn":
        h, cache = layers.attention(p["attn"], layers.norm(p["ln1"], x, cfg),
                                    cfg, positions=positions, pos0=pos0,
                                    cache=cache, window=cfg.local_window,
                                    angles=angles)
        x = x + h
        z = layers.norm(p["ln2"], x, cfg)
        if cfg.moe:
            h, aux = moe.moe_block(p["ffn"], z, cfg)
        else:
            h = layers.mlp(p["ffn"], z, cfg)
        x = x + h
    elif kind == "rglru":
        h, cache = rglru.rglru_block(p["rec"], layers.norm(p["ln1"], x, cfg),
                                     cfg, state=cache)
        x = x + h
        x = x + layers.mlp(p["ffn"], layers.norm(p["ln2"], x, cfg), cfg)
    elif kind == "rwkv":
        h, cache = rwkv6.time_mix(p["tm"], layers.norm(p["ln1"], x, cfg),
                                  cfg, state=cache)
        x = x + h
        h, cache = rwkv6.channel_mix(p["cm"], layers.norm(p["ln2"], x, cfg),
                                     cfg, state=cache)
        x = x + h
    else:
        raise ValueError(kind)
    return x, cache, aux


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device=None) -> dict:
    if kind == "attn":
        return layers.init_cache(cfg, batch, max_len,
                                 window=cfg.local_window, device=device)
    if kind == "rglru":
        return rglru.init_rglru_state(cfg, batch, device=device)
    if kind == "rwkv":
        return rwkv6.init_rwkv_state(cfg, batch, device=device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# frontends (stubs)
# ---------------------------------------------------------------------------
def init_frontend(gen: torch.Generator, cfg: ModelConfig) -> Params:
    if cfg.frontend == "vision_stub":
        return {"proj": layers.init_linear(gen, VISION_FEAT_DIM, cfg.d_model,
                                           cfg)}
    if cfg.frontend == "audio_stub":
        w = AUDIO_CONV_POS_WIDTH
        return {
            "proj": layers.init_linear(gen, AUDIO_FEAT_DIM, cfg.d_model, cfg),
            "conv_pos": torch.randn((w, cfg.d_model), generator=gen,
                                    device=gen.device,
                                    dtype=layers.pdtype(cfg))
            * (w * cfg.d_model) ** -0.5,
        }
    return {}


def apply_frontend(p: Params, feats: Tensor, cfg: ModelConfig) -> Tensor:
    h = layers.linear(p["proj"], feats.to(layers.cdtype(cfg)), cfg)
    if cfg.frontend == "audio_stub":
        # convolutional positional embedding == TINA depthwise FIR (§4.3)
        pos = tina.depthwise_fir(h, p["conv_pos"].to(h.dtype), causal=True,
                                 lowering=rglru.fir_lowering(cfg))
        h = h + F.gelu(pos, approximate="tanh")
    return h


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
def _pattern_layout(cfg: ModelConfig) -> tuple[tuple, int, tuple]:
    pat = tuple(cfg.block_pattern)
    reps = cfg.n_layers // len(pat)
    tail = tuple(cfg.layer_kinds[reps * len(pat):])
    return pat, reps, tail


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None,
               generator: Optional[torch.Generator] = None) -> Params:
    """Random weights of the reference's shapes and scales, from an
    explicit generator (or one on ``device`` seeded with ``seed``; CUDA
    unless the caller asks for the CPU).  The reference's jax.random
    draws other numbers: tests carry its weights across with
    :func:`repro_torch.models.convert.from_jax`."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(seed)
    gen = generator
    pat, reps, tail = _pattern_layout(cfg)
    p: Params = {"embed": layers.init_embedding(gen, cfg),
                 "final_norm": layers.init_norm(cfg, gen.device)}
    if cfg.frontend:
        p["frontend"] = init_frontend(gen, cfg)
    if not cfg.tie_embeddings:
        p["head"] = layers.init_linear(gen, cfg.d_model, cfg.vocab_size, cfg,
                                       scale=cfg.d_model ** -0.5)
    p["stack"] = [{f"sub{i}": init_block(gen, cfg, kind)
                   for i, kind in enumerate(pat)} for _ in range(reps)]
    p["tail"] = [init_block(gen, cfg, kind) for kind in tail]
    return p


def _prepare_mlp(p: Params, cfg: ModelConfig) -> Params:
    return {k: layers.prepare_linear(v, cfg) for k, v in p.items()}


# the linears of each part of a block; the rest of a part are tensors
_LINEARS = {"attn": ("wq", "wk", "wv", "wo"), "rec": rglru.LINEARS,
            "tm": rwkv6.TIME_MIX_LINEARS, "cm": rwkv6.CHANNEL_MIX_LINEARS}


def _prepare_block(p: Params, cfg: ModelConfig) -> Params:
    out = dict(p)
    for part, names in _LINEARS.items():
        if part in p:
            out[part] = {k: layers.prepare_linear(v, cfg) if k in names
                         else v for k, v in p[part].items()}
    f = p.get("ffn")
    if f is not None and "router" in f:          # the MoE block
        cd = layers.cdtype(cfg)
        out["ffn"] = {**f, **{k: f[k].to(cd) for k in moe.EXPERT_WEIGHTS},
                      **{k: _prepare_mlp(f[k], cfg)
                         for k in ("shared", "dense") if k in f}}
    elif f is not None:
        out["ffn"] = _prepare_mlp(f, cfg)
    return out


def prepare(params: Params, cfg: ModelConfig) -> Params:
    """The serving form of ``params``, made once when the weights are
    loaded: every linear (of the blocks and the frontend) gains its
    weight cast to the compute dtype as a K-major copy
    (:func:`layers.prepare_linear`), the experts' weights are cast to the
    compute dtype (no copy where they are in it), and an untied head
    gains its weight rounded through the compute dtype, in f32 (what the
    reference's head computes with on every call).  Every other tensor is
    shared, not copied."""
    out = {**params,
           "stack": [{k: _prepare_block(v, cfg) for k, v in sb.items()}
                     for sb in params["stack"]],
           "tail": [_prepare_block(p, cfg) for p in params["tail"]]}
    if "frontend" in params:
        fr = params["frontend"]
        out["frontend"] = {**fr, "proj": layers.prepare_linear(fr["proj"],
                                                               cfg)}
    if "head" in params and layers.cdtype(cfg) != torch.float32:
        w = params["head"]["w"]
        out["head"] = {**params["head"],
                       "wr": w.to(layers.cdtype(cfg)).float()}
    return out


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device=None) -> dict:
    dev = resolve_device(device)
    pat, reps, tail = _pattern_layout(cfg)
    return {"stack": [{f"sub{i}": init_block_cache(cfg, kind, batch, max_len,
                                                   dev)
                       for i, kind in enumerate(pat)} for _ in range(reps)],
            "tail": [init_block_cache(cfg, kind, batch, max_len, dev)
                     for kind in tail]}


def _remat_segments(cfg: ModelConfig, reps: int, remat: bool
                    ) -> list[tuple[range, bool]]:
    """The stack's superblocks as (repeats, checkpointed) runs, the
    reference's schedule: one run per superblock, checkpointed where
    ``remat``; with ``cfg.remat_group`` g > 1 (and ``cfg.use_scan``, as
    the reference's unrolled stack takes no groups), one checkpointed run
    per g superblocks, then the remainder one superblock a run."""
    g = cfg.remat_group if cfg.use_scan else 1
    if g > 1:
        n_grp = reps // g
        return ([(range(j * g, (j + 1) * g), True) for j in range(n_grp)]
                + [(range(r, r + 1), remat)
                   for r in range(n_grp * g, reps)])
    return [(range(r, r + 1), remat) for r in range(reps)]


def _run_blocks(params: Params, x: Tensor, cfg: ModelConfig, *,
                positions: Tensor, pos0: int, caches: Optional[dict],
                remat: bool = False) -> tuple[Tensor, Optional[dict], dict]:
    """The stack, then the tail; the blocks' MoE statistics summed in
    layer order, as the reference's ``_run_blocks`` sums them.  ``remat``
    (and ``cfg.remat_group``) checkpoint the stack when there are no
    caches and autograd is on."""
    pat, reps, tail = _pattern_layout(cfg)
    angles = layers.rope_angles(positions, cfg)

    def run(x, blocks):
        aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
               for k in AUX_KEYS}
        for p, kind, c in blocks:
            # c is written in place: the returned cache is c itself
            x, _, aux_l = apply_block(p, x, cfg, kind, positions=positions,
                                      pos0=pos0, cache=c, angles=angles)
            for k in AUX_KEYS:
                if k in aux_l:
                    aux[k] = aux[k] + aux_l[k]
        return x, aux

    def stack(rs):
        return [(params["stack"][r][f"sub{i}"], kind,
                 None if caches is None else caches["stack"][r][f"sub{i}"])
                for r in rs for i, kind in enumerate(pat)]

    if caches is None and torch.is_grad_enabled():
        segments = _remat_segments(cfg, reps, remat)
    else:
        segments = [(range(reps), False)]
    aux = None
    for rs, ckpt in segments:
        if ckpt:
            x, aux_s = checkpoint(run, x, stack(rs), use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            x, aux_s = run(x, stack(rs))
        aux = aux_s if aux is None else {k: aux[k] + aux_s[k]
                                         for k in AUX_KEYS}
    x, aux_t = run(x, [(params["tail"][i], kind,
                        None if caches is None else caches["tail"][i])
                       for i, kind in enumerate(tail)])
    aux = aux_t if aux is None else {k: aux[k] + aux_t[k] for k in AUX_KEYS}
    return x, caches, aux


def embed_inputs(params: Params, batch: dict, cfg: ModelConfig
                 ) -> tuple[Tensor, Tensor]:
    """Returns (hidden, positions): the patches' projections before the
    tokens' embeddings (vision), the frames' (audio), or the tokens'."""
    if cfg.frontend == "vision_stub":
        patches = apply_frontend(params["frontend"], batch["patch_embeds"],
                                 cfg)
        toks = layers.embed(params["embed"], batch["tokens"], cfg)
        h = torch.cat([patches, toks], 1)
    elif cfg.frontend == "audio_stub":
        h = apply_frontend(params["frontend"], batch["frames"], cfg)
    else:
        h = layers.embed(params["embed"], batch["tokens"], cfg)
    b, s = h.shape[0], h.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(b, s)
    return h, positions


def _logits(params: Params, h: Tensor, cfg: ModelConfig) -> Tensor:
    h = layers.norm(params["final_norm"], h, cfg)
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], h, cfg)
    return layers.linear(params["head"], h.float(),
                         cfg.scaled(use_tina=False))


def forward(params: Params, batch: dict, cfg: ModelConfig, *,
            caches: Optional[dict] = None, remat: Optional[bool] = None
            ) -> tuple[Tensor, Optional[dict], dict]:
    """Full-sequence forward (prefill when ``caches`` are given: they are
    filled in place).  Returns (logits, caches, aux); aux holds the
    reference's MoE statistics summed over the blocks (zero without
    experts).  ``remat`` (default ``cfg.remat``) checkpoints the stack
    for training: the same values, recomputed in the backward."""
    remat = cfg.remat if remat is None else remat
    h, positions = embed_inputs(params, batch, cfg)
    h, caches, aux = _run_blocks(params, h, cfg, positions=positions,
                                 pos0=0, caches=caches, remat=remat)
    return _logits(params, h, cfg), caches, aux


def decode_step(params: Params, tokens: Tensor, caches: dict,
                cfg: ModelConfig) -> tuple[Tensor, dict]:
    """One autoregressive step.  tokens: (B,) int.  The position comes
    from the caches' counters (:func:`_cache_pos`); the caches are
    written in place and returned."""
    h = layers.embed(params["embed"], tokens[:, None], cfg)
    pos = _cache_pos(caches)
    positions = torch.full((h.shape[0], 1), pos, dtype=torch.int32,
                           device=h.device)
    h, caches, _ = _run_blocks(params, h, cfg, positions=positions,
                               pos0=pos, caches=caches)
    return _logits(params, h, cfg)[:, 0], caches


def _cache_pos(caches: dict) -> int:
    """Global decode position: the largest counter of the attention
    caches; 0 for a stack without one (recurrent states need none)."""
    every = [c for sb in caches["stack"] for c in sb.values()]
    every += caches["tail"]
    return max([0] + [c["pos"] for c in every if "pos" in c])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _ce(logits: Tensor, targets: Tensor, mask: Tensor
        ) -> tuple[Tensor, Tensor]:
    """Mean cross-entropy over ``mask`` and its denominator, the
    reference's where-iota form: f32 logits, ``logsumexp``, and the gold
    logit taken as a masked sum over the vocab (not a gather)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, -1)
    vocab_ids = torch.arange(logits.shape[-1], dtype=torch.int32,
                             device=logits.device)
    gold = torch.where(vocab_ids == targets[..., None].to(torch.int32),
                       logits, 0.0).sum(-1)
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    return nll.sum() / denom, denom


def loss_fn(params: Params, batch: dict, cfg: ModelConfig
            ) -> tuple[Tensor, dict]:
    """(loss + 0.01 * moe_aux_loss, metrics): causal next-token CE; the
    vlm's on its text positions alone; hubert's masked-prediction CE on
    ``batch["targets"]`` where ``batch["mask"]``.  Metrics: ``loss``,
    ``tokens`` (the CE's denominator), ``moe_aux_loss``,
    ``moe_drop_frac``."""
    logits, _, aux = forward(params, batch, cfg)
    if cfg.frontend == "audio_stub":
        loss, denom = _ce(logits, batch["targets"], batch["mask"].float())
    elif cfg.frontend == "vision_stub":
        npatch = batch["patch_embeds"].shape[1]
        targets = batch["tokens"][:, 1:]
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
        loss, denom = _ce(logits[:, npatch:-1], targets, mask)
    else:
        targets = batch["tokens"][:, 1:]
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
        loss, denom = _ce(logits[:, :-1], targets, mask)
    total = loss + 0.01 * aux["moe_aux_loss"]
    return total, {"loss": loss, "tokens": denom, **aux}
