"""Pipeline parallelism over a ``stage`` mesh axis, the port of the
reference's ``repro.distributed.pipeline``: a GPipe-schedule microbatched
train step over logical stages.

  * the stack's repeat axis is split across stages (stage s owns
    superblock repeats [s*R/S, (s+1)*R/S)) on the mesh's device s;
  * microbatches stream through: at tick t, stage s applies its
    sub-stack to microbatch t - s, then hands the activation to stage
    s + 1 (``.to`` its device: nothing moves when the stages share a
    card); n_micro + S - 1 ticks, the classic bubble of (S-1) ticks;
  * every stage-tick runs under ``torch.utils.checkpoint`` (non-reentrant),
    as the reference's runs under ``jax.checkpoint``: live activations
    stay one per stage-tick, each recomputed in the backward;
  * backward is autograd through the whole schedule.

The embedding runs once per microbatch, at stage 0, and the final norm,
head and cross-entropy once, at the last stage (the reference computes
both on every stage and masks them, to keep its SPMD program uniform;
the loss and gradients are the same).  The loss is the token-weighted
mean over all microbatches, without the MoE aux term.

The stages of one card run one after another in tick order on the
current stream; a mesh that names distinct cards runs each stage's
blocks on its own card.

Restriction: ``cfg.n_layers`` a multiple of ``len(block_pattern) *
n_stages`` (no tail), token models only, training only.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import convert, layers
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (clip_by_global_norm, make_optimizer,
                               warmup_cosine)
from repro_torch.tree import leaves, map_tree, unflatten


def _split(x: torch.Tensor, n_stages: int) -> torch.Tensor:
    reps = x.shape[0]
    if reps % n_stages:
        raise ValueError(f"stage_split_params: {reps} repeats of the stack "
                         f"do not split into {n_stages} stages")
    return x.reshape((n_stages, reps // n_stages) + tuple(x.shape[1:]))


def stage_split_params(params, n_stages: int):
    """The training layout's stack leaves (reps, ...) viewed as
    (n_stages, reps/n_stages, ...); embed/head/norm stay as they are."""
    out = dict(params)
    out["stack"] = map_tree(lambda x: _split(x, n_stages), params["stack"])
    return out


def make_pipeline_train_step(cfg: ModelConfig, mesh, *, n_micro: int,
                             lr_fn=None):
    """``(train_step, optimizer)``: ``train_step(params, opt_state, batch)
    -> (params, opt_state, metrics)`` runs the block stack as a
    ``stage``-axis pipeline over ``mesh`` (a ``launch.mesh.BatchMesh``
    whose axis is ``"stage"``; ``BatchMesh(("cuda:0",) * 4,
    axis="stage")`` is four logical stages of one card).  Parameters and
    optimizer state are in the training layout on the mesh's first
    device and are updated in place; ``batch["tokens"]`` (B, S) splits
    into ``n_micro`` microbatches.  The update casts the gradients to
    f32, clips them at global norm 1.0 and applies ``make_optimizer(cfg,
    lr_fn or warmup_cosine(3e-4, 100, 10_000))``; metrics are ``loss``
    and ``grad_norm`` (before the clip).

    Raises ``ValueError`` for a stack with a tail, repeats that do not
    split evenly into the stages, a frontend config,
    ``tina_lowering == "kernel"`` (no gradient, as ``make_train_step``),
    and, per call, a batch that does not split into ``n_micro``."""
    if "stage" not in mesh.shape:
        raise ValueError(f"make_pipeline_train_step: the mesh's axes are "
                         f"{sorted(mesh.shape)}, not 'stage'")
    n_stages = mesh.shape["stage"]
    pat, reps, tail = model_lib._pattern_layout(cfg)
    if tail:
        raise ValueError(f"make_pipeline_train_step: {cfg.n_layers} layers "
                         f"leave a tail of {len(tail)} after the "
                         f"{len(pat)}-block pattern")
    if reps % n_stages:
        raise ValueError(f"make_pipeline_train_step: {reps} repeats do not "
                         f"split into {n_stages} stages")
    if cfg.frontend:
        raise ValueError(f"make_pipeline_train_step: {cfg.name} has a "
                         f"{cfg.frontend} frontend; the pipeline trains "
                         "token models")
    if cfg.tina_lowering == "kernel":
        raise ValueError(
            "make_pipeline_train_step: tina_lowering='kernel' has no "
            "gradient; train at 'native' or 'conv'")
    devices = mesh.devices
    dev0, last = devices[0], devices[-1]
    per_stage = reps // n_stages
    opt = make_optimizer(cfg, lr_fn or warmup_cosine(3e-4, 100, 10_000))

    def run_stage(x, blocks, angles, positions):
        for p_sb in blocks:
            for i, kind in enumerate(pat):
                x, _, _ = model_lib.apply_block(
                    p_sb[f"sub{i}"], x, cfg, kind, positions=positions,
                    pos0=0, cache=None, angles=angles)
        return x

    def pipeline_loss(params, tokens):
        """tokens: (n_micro, mb, S) on the first device."""
        nm, mb, s = tokens.shape
        repeats = convert.unstack_views(params)["stack"]
        stages, ctx = [], {}
        for st, dev in enumerate(devices):
            if dev not in ctx:
                pos = torch.arange(s, dtype=torch.int32,
                                   device=dev).expand(mb, s)
                ctx[dev] = (layers.rope_angles(pos, cfg), pos)
            stages.append([map_tree(lambda x: x.to(dev), sb) for sb in
                           repeats[st * per_stage:(st + 1) * per_stage]])
        head = {k: map_tree(lambda x: x.to(last), params[k])
                for k in ("embed", "final_norm", "head") if k in params}
        mask = torch.ones((mb, s - 1), dtype=torch.float32, device=last)
        loss_sum = torch.zeros((), dtype=torch.float32, device=last)
        tok_sum = torch.zeros((), dtype=torch.float32, device=last)
        held = [None] * n_stages
        for t in range(nm + n_stages - 1):
            # last stage first: stage st takes what stage st - 1 held
            # after the previous tick before stage st - 1 runs this one
            for st in reversed(range(n_stages)):
                m = t - st
                if not 0 <= m < nm:
                    continue
                if st == 0:
                    x = layers.embed(params["embed"], tokens[m], cfg).to(
                        layers.cdtype(cfg))
                else:
                    x, held[st - 1] = held[st - 1].to(devices[st]), None
                angles, pos = ctx[devices[st]]
                y = checkpoint(run_stage, x, stages[st], angles, pos,
                               use_reentrant=False, preserve_rng_state=False)
                if st < n_stages - 1:
                    held[st] = y
                    continue
                logits = model_lib._logits(head, y, cfg)
                nll, denom = model_lib._ce(logits[:, :-1],
                                           tokens[m, :, 1:].to(last), mask)
                loss_sum = loss_sum + nll * denom
                tok_sum = tok_sum + denom
        return (loss_sum / torch.clamp(tok_sum, min=1.0)).to(dev0)

    def train_step(params, opt_state, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev0)
        b = tokens.shape[0]
        if b % n_micro:
            raise ValueError(f"pipeline train_step: a batch of {b} rows in "
                             f"{n_micro} microbatches")
        wrong = {str(t.device) for t in leaves(params) if t.device != dev0}
        if wrong:
            raise ValueError(f"pipeline train_step: params on "
                             f"{sorted(wrong)}, the step runs from {dev0}")
        ptree = map_tree(lambda t: t.detach().requires_grad_(), params)
        diff = leaves(ptree)
        with torch.enable_grad():
            loss = pipeline_loss(ptree, tokens.reshape(n_micro, b // n_micro,
                                                       -1))
            gs = torch.autograd.grad(loss, diff, allow_unused=True)
        gs = [torch.zeros_like(p, dtype=torch.float32) if g is None
              else g.float() for g, p in zip(gs, diff)]
        grads, gnorm = clip_by_global_norm(unflatten(params, gs), 1.0,
                                           inplace=True)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(),
                                   "grad_norm": gnorm.detach()}

    return train_step, opt


__all__ = ["stage_split_params", "make_pipeline_train_step"]
