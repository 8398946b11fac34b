"""Model assembly for the dense decoders: the port of the reference's
``repro.models.model`` for attention blocks without experts.

The reference runs its layer stack as ``lax.scan`` over repeats of
``cfg.block_pattern`` with remat; serving needs neither, so the stack
here is a plain loop over the repeats (``params["stack"]``, one dict per
repeat: the reference's vmapped tree unstacked, see
:mod:`repro_torch.models.convert`) and then the unrolled tail.

Ported: kind ``attn`` without experts and token inputs.  The ``moe``,
``rglru`` and ``rwkv`` blocks and the ``vision_stub`` / ``audio_stub``
frontends raise NotImplementedError when a model is built
(:func:`check_ported`); nothing else stands in for them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = dict

VISION_FEAT_DIM = 1024   # InternViT output (stub)
AUDIO_FEAT_DIM = 512     # wav2vec2/HuBERT conv-extractor output (stub)


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless every block of ``cfg`` is an
    attention block without experts and its inputs are tokens."""
    kinds = sorted(set(cfg.block_pattern) - {"attn"})
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: the moe blocks ({cfg.family}) are not yet ported")
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: the {', '.join(kinds)} blocks ({cfg.family}) are "
            "not yet ported")
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend ({cfg.family}) is not "
            "yet ported")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    if kind != "attn" or cfg.moe:
        check_ported(cfg)
        raise ValueError(kind)
    return {"ln1": layers.init_norm(cfg, gen.device),
            "ln2": layers.init_norm(cfg, gen.device),
            "attn": layers.init_attention(gen, cfg),
            "ffn": layers.init_mlp(gen, cfg)}


def apply_block(p: Params, x: Tensor, cfg: ModelConfig, kind: str, *,
                positions: Tensor, pos0: int, cache: Optional[dict],
                angles=None) -> tuple[Tensor, Optional[dict]]:
    if kind != "attn" or cfg.moe:
        check_ported(cfg)
        raise ValueError(kind)
    h, new_cache = layers.attention(p["attn"], layers.norm(p["ln1"], x, cfg),
                                    cfg, positions=positions, pos0=pos0,
                                    cache=cache, window=cfg.local_window,
                                    angles=angles)
    x = x + h
    x = x + layers.mlp(p["ffn"], layers.norm(p["ln2"], x, cfg), cfg)
    return x, new_cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device=None) -> dict:
    if kind != "attn":
        check_ported(cfg)
        raise ValueError(kind)
    return layers.init_cache(cfg, batch, max_len, window=cfg.local_window,
                             device=device)


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
    check_ported(cfg)
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(seed)
    gen = generator
    pat, reps, tail = _pattern_layout(cfg)
    p: Params = {"embed": layers.init_embedding(gen, cfg),
                 "final_norm": layers.init_norm(cfg, gen.device)}
    if not cfg.tie_embeddings:
        p["head"] = layers.init_linear(gen, cfg.d_model, cfg.vocab_size, cfg,
                                       scale=cfg.d_model ** -0.5)
    p["stack"] = [{f"sub{i}": init_block(gen, cfg, kind)
                   for i, kind in enumerate(pat)} for _ in range(reps)]
    p["tail"] = [init_block(gen, cfg, kind) for kind in tail]
    return p


def _blocks(params: Params):
    for sb in params["stack"]:
        yield from sb.values()
    yield from params["tail"]


def prepare(params: Params, cfg: ModelConfig) -> Params:
    """The serving form of ``params``, made once when the weights are
    loaded: every linear of every block gains its weight cast to the
    compute dtype as a K-major copy (:func:`layers.prepare_linear`), and
    an untied head its weight rounded through the compute dtype, in f32
    (what the reference's head computes with on every call).  The f32
    tensors are shared, not copied."""
    def block(p):
        return {**p,
                "attn": {k: layers.prepare_linear(v, cfg)
                         for k, v in p["attn"].items()},
                "ffn": {k: layers.prepare_linear(v, cfg)
                        for k, v in p["ffn"].items()}}

    out = {**params,
           "stack": [{k: block(v) for k, v in sb.items()}
                     for sb in params["stack"]],
           "tail": [block(p) for p in params["tail"]]}
    if "head" in params and layers.cdtype(cfg) != torch.float32:
        w = params["head"]["w"]
        out["head"] = {**params["head"],
                       "wr": w.to(layers.cdtype(cfg)).float()}
    return out


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device=None) -> dict:
    check_ported(cfg)
    dev = resolve_device(device)
    pat, reps, tail = _pattern_layout(cfg)
    return {"stack": [{f"sub{i}": init_block_cache(cfg, kind, batch, max_len,
                                                   dev)
                       for i, kind in enumerate(pat)} for _ in range(reps)],
            "tail": [init_block_cache(cfg, kind, batch, max_len, dev)
                     for kind in tail]}


def _run_blocks(params: Params, x: Tensor, cfg: ModelConfig, *,
                positions: Tensor, pos0: int, caches: Optional[dict]
                ) -> tuple[Tensor, Optional[dict]]:
    pat, reps, tail = _pattern_layout(cfg)
    angles = layers.rope_angles(positions, cfg)
    for r in range(reps):
        for i, kind in enumerate(pat):
            c = None if caches is None else caches["stack"][r][f"sub{i}"]
            x, _ = apply_block(params["stack"][r][f"sub{i}"], x, cfg, kind,
                               positions=positions, pos0=pos0, cache=c,
                               angles=angles)
    for i, kind in enumerate(tail):
        c = None if caches is None else caches["tail"][i]
        x, _ = apply_block(params["tail"][i], x, cfg, kind,
                           positions=positions, pos0=pos0, cache=c,
                           angles=angles)
    return x, caches


def embed_inputs(params: Params, batch: dict, cfg: ModelConfig
                 ) -> tuple[Tensor, Tensor]:
    """Returns (hidden, positions) for token inputs."""
    check_ported(cfg)
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
            caches: Optional[dict] = None
            ) -> tuple[Tensor, Optional[dict], dict]:
    """Full-sequence forward (prefill when ``caches`` are given: they are
    filled in place).  Returns (logits, caches, aux); aux holds the
    reference's MoE statistics, zero for dense blocks."""
    h, positions = embed_inputs(params, batch, cfg)
    h, caches = _run_blocks(params, h, cfg, positions=positions, pos0=0,
                            caches=caches)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    return _logits(params, h, cfg), caches, {"moe_aux_loss": zero,
                                             "moe_drop_frac": zero}


def decode_step(params: Params, tokens: Tensor, caches: dict,
                cfg: ModelConfig) -> tuple[Tensor, dict]:
    """One autoregressive step.  tokens: (B,) int.  The position comes
    from the caches' counters (:func:`_cache_pos`); the caches are
    written in place and returned."""
    h = layers.embed(params["embed"], tokens[:, None], cfg)
    pos = _cache_pos(caches)
    positions = torch.full((h.shape[0], 1), pos, dtype=torch.int32,
                           device=h.device)
    h, caches = _run_blocks(params, h, cfg, positions=positions, pos0=pos,
                            caches=caches)
    return _logits(params, h, cfg)[:, 0], caches


def _cache_pos(caches: dict) -> int:
    """Global decode position: the largest of the attention caches'
    counters (0 for a stack without one)."""
    return max([0] + [c["pos"] for sb in caches["stack"] for c in sb.values()]
               + [c["pos"] for c in caches["tail"]])
