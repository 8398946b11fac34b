"""Step builders on one device: the train step, prefill and decode, the
port of the reference's ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` (``repro.distributed.step``).

The reference jits each step over a mesh and donates its buffers; here a
step is a plain callable on one device.  Serving writes into the
preallocated cache tensors (:func:`repro_torch.models.model.init_caches`)
in place and returns them; the train step updates parameters and
optimizer state in place (``donate``).  The mesh (and the gradient
all-reduce that ``grad_wire`` narrows) is the multi-device stack's, not
yet ported.  hubert (encoder-only) builds both serving steps, as in the
reference; its server runs no decode (``launch.serve``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.data.pipeline import batch_shapes, input_specs
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (clip_by_global_norm, make_optimizer,
                               warmup_cosine)
from repro_torch.tree import flatten_with_path, leaves, map_tree, unflatten

# the batch entries each family's forward reads (data.pipeline's trees;
# an audio batch's targets and mask are the training loss's)
_INPUTS = {"vlm": ("tokens", "patch_embeds"), "audio": ("frames",)}


def _check(what: str, got: tuple, want: tuple) -> None:
    if tuple(got) != tuple(want):
        raise ValueError(f"{what}: shape {tuple(got)}, the step was built "
                         f"for {tuple(want)}")


@dataclasses.dataclass
class StepSpecs:
    """A train step's operands as ``meta`` tensors (shapes and dtypes,
    nothing allocated): what a checkpoint restores into."""
    params: Any = None        # the training layout (models.convert)
    opt_state: Any = None
    batch: Any = None


def param_specs(cfg: ModelConfig) -> dict:
    """``init_model``'s parameters in the training layout, as ``meta``
    tensors: the initializers run on fake tensors, so nothing is
    allocated even for a full config."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = convert.stack_params(
            model_lib.init_model(cfg, generator=torch.Generator()))
    return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


def _serving_copies(params) -> list[str]:
    """The keys of ``models.model.prepare``'s serving copies in
    ``params``: a linear's ``wt`` and an untied head's rounded ``wr``
    tensor (rwkv6's receptance linear, a dict also named ``wr``, is a
    parameter)."""
    return [k for k, _ in flatten_with_path(params)
            if k.rsplit("/", 1)[-1] == "wt" or k == "head/wr"]


def value_and_grad(params, batch: dict, cfg: ModelConfig
                   ) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of :func:`models.model.loss_fn` at
    training-layout ``params`` (left as they are): the total loss and
    the metrics detached, the gradients in the params' layout (dicts'
    keys sorted), zeros for a leaf the loss does not reach (hubert's
    token table)."""
    ptree = map_tree(lambda t: t.detach().requires_grad_(), params)
    diff = leaves(ptree)
    with torch.enable_grad():
        total, metrics = model_lib.loss_fn(convert.unstack_views(ptree),
                                           batch, cfg)
        gs = torch.autograd.grad(total, diff, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, diff)]
    return total.detach(), {
        k: v.detach() for k, v in metrics.items()
        if k in ("loss", "tokens") + model_lib.AUX_KEYS}, unflatten(params,
                                                                    gs)


def make_train_step(cfg: ModelConfig, *, batch_size: int, seq_len: int,
                    lr_fn=None, grad_wire: str = "bf16",
                    microbatch: Optional[int] = None, donate: bool = True,
                    device=None) -> tuple[Callable, StepSpecs]:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` and its :class:`StepSpecs`: the gradients of
    :func:`models.model.loss_fn`, their ``grad_wire`` round trip
    (``"bf16"``: to bf16 and back to f32, the reference's wire cast),
    ``microbatch=k`` accumulation over k slices of the batch (f32, in
    slice order, then / k), the clip at global norm 1.0 and the
    optimizer's update, in the reference's order.  Metrics gain
    ``grad_norm`` (before the clip).

    Parameters and optimizer state are in the training layout
    (:func:`models.convert.stack_params`) on ``device`` (CUDA unless the
    caller asks for the CPU); ``donate`` updates them in place (else the
    step works on copies).  Raises ``ValueError`` for
    ``cfg.tina_lowering == "kernel"``, on every device (the reference
    cannot differentiate its ``pallas`` lowering either, and on the card
    the port's GEMM kernels have no backward), and for parameters that
    carry ``models.model.prepare``'s serving copies (an update would
    leave them stale)."""
    if cfg.tina_lowering == "kernel":
        raise ValueError(
            "make_train_step: tina_lowering='kernel' has no gradient (the "
            "reference cannot differentiate its 'pallas' lowering either); "
            "train at 'native' or 'conv'")
    if grad_wire not in ("bf16", "none"):
        raise ValueError(f"grad_wire {grad_wire!r}: 'bf16' or 'none'")
    dev = resolve_device(device)
    opt = make_optimizer(cfg, lr_fn or warmup_cosine(3e-4, 2000, 100_000))
    k = microbatch or 1

    def grads_of(params, batch):
        _, metrics, grads = value_and_grad(params, batch, cfg)
        gs = leaves(grads)
        if grad_wire == "bf16":
            for g in gs:
                if g.dtype == torch.float32:
                    g.copy_(g.to(torch.bfloat16))
        return [g.float() for g in gs], metrics

    def train_step(params, opt_state, batch):
        bad = _serving_copies(params)
        if bad:
            raise ValueError(
                f"train_step: params carry serving copies {bad[:3]} "
                "(models.model.prepare); train on unprepared params")
        wrong = {str(t.device) for t in leaves(params) if t.device != dev}
        if wrong:
            raise ValueError(f"train_step: params on {sorted(wrong)}, the "
                             f"step was built for {dev}")
        if not donate:
            params = map_tree(torch.clone, params)
            opt_state = map_tree(torch.clone, opt_state)
        batch = {key: torch.as_tensor(v, device=dev)
                 for key, v in batch.items()}
        if k > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % k:
                raise ValueError(f"train_step: a batch of {rows} rows in "
                                 f"{k} microbatches")
            n = rows // k
            grads = metrics = None
            for i in range(k):
                g, m = grads_of(params, {key: v[i * n:(i + 1) * n]
                                         for key, v in batch.items()})
                if grads is None:
                    grads, metrics = g, m
                else:
                    for a, b in zip(grads, g):
                        a.add_(b)
                    metrics = {key: metrics[key] + m[key] for key in m}
            for g in grads:
                g.div_(k)
            metrics = {key: v / k for key, v in metrics.items()}
        else:
            grads, metrics = grads_of(params, batch)
        grads, gnorm = clip_by_global_norm(unflatten(params, grads), 1.0,
                                           inplace=True)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {**metrics, "grad_norm": gnorm.detach()}

    pspecs = param_specs(cfg)
    specs = StepSpecs(params=pspecs, opt_state=opt.init(pspecs),
                      batch=input_specs(cfg, batch_size, seq_len))
    return train_step, specs


def make_prefill_step(cfg: ModelConfig, *, batch_size: int,
                      seq_len: int) -> Callable:
    """``prefill(params, batch, caches) -> (last logits (B, V), caches)``:
    forward the whole prompt, fill the caches, return the last
    position's logits.  ``seq_len`` counts every position: a vlm
    prompt's patches and tokens (``data.pipeline.batch_shapes``)."""
    shapes = batch_shapes(cfg, batch_size, seq_len)
    want = {k: shapes[k][0] for k in _INPUTS.get(cfg.family, ("tokens",))}

    def prefill(params, batch, caches):
        for k, shape in want.items():
            _check(f"prefill {k}", batch[k].shape, shape)
        logits, caches, _ = model_lib.forward(params, batch, cfg,
                                              caches=caches)
        return logits[:, -1], caches

    return prefill


def make_decode_step(cfg: ModelConfig, *, batch_size: int,
                     cache_len: int) -> Callable:
    """``decode(params, tokens, caches) -> (next tokens, logits, caches)``:
    one greedy token against ``cache_len``-long caches (the attention
    caches' length; a recurrent state has none, only a batch axis)."""
    w = cfg.local_window
    size = min(cache_len, w) if w else cache_len

    def decode(params, tokens, caches):
        _check("decode tokens", tokens.shape, (batch_size,))
        every = [c for sb in caches["stack"] for c in sb.values()]
        every += caches["tail"]
        attn = [c for c in every if "k" in c]
        if attn:
            _check("decode cache", attn[0]["k"].shape[:2],
                   (batch_size, size))
        else:
            state = next(iter(every[0].values()))
            _check("decode state", state.shape[:1], (batch_size,))
        logits, caches = model_lib.decode_step(params, tokens, caches, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, caches

    return decode


__all__ = ["StepSpecs", "param_specs", "value_and_grad", "make_train_step",
           "make_prefill_step", "make_decode_step"]
