"""Step builders: the train step, prefill and decode, the port of the
reference's ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` (``repro.distributed.step``).

The reference jits each step over a mesh and donates its buffers; here a
step is a plain callable.  Without a mesh (``mesh=None``) it runs on one
device.  Serving writes into the preallocated cache tensors
(:func:`repro_torch.models.model.init_caches`) in place and returns
them; the train step updates parameters and optimizer state in place
(``donate``).  hubert (encoder-only) builds both serving steps, as in
the reference; its server runs no decode (``launch.serve``).

With a :class:`repro_torch.launch.mesh.Mesh` of axes ``data`` and
``model`` (and ``pod``), a step is SPMD over the mesh's positions, one
process driving them all (:mod:`repro_torch.models.sharded`): its
parameters, optimizer state and caches are lists with one tree a
position (:func:`repro_torch.models.convert.shard_params` under the
step's :class:`StepSpecs`), its batch the global one, which it splits
over the data axes.  ``layout="tp"``: data parallel over ``("pod",
"data")``, Megatron tensor parallel and expert parallel over ``model``,
ZeRO-3 over ``data`` under ``cfg.fsdp`` (with ``sequence_parallel``:
Megatron-SP, the train step only); ``layout="fsdp"``: no tensor
parallelism, ZeRO-3 over ``model``, the embedding, head and experts
still split over it; ``layout="sp"``: no tensor parallelism, the
sequence over ``model``, the embedding, head and experts still split
over it.  Every family shards (:mod:`repro_torch.models.sharded`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.data.pipeline import batch_shapes, input_specs
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shr
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.models import sharded
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (clip_by_global_norm, make_optimizer,
                               warmup_cosine)
from repro_torch.partitioning import P, PartitionSpec, default_rules
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
    """A step's operands as ``meta`` tensors (shapes and dtypes, nothing
    allocated): what a checkpoint restores into.  A sharded step's also
    carry the ``PartitionSpec`` of every leaf (``*_sh``: what
    ``convert.shard_params`` and ``convert.unshard`` take), the compute
    layout's (``compute_sh``), its mesh, rules and
    :class:`repro_torch.models.sharded.Layout`."""
    params: Any = None        # the training layout (models.convert)
    opt_state: Any = None
    batch: Any = None
    params_sh: Any = None
    opt_state_sh: Any = None
    compute_sh: Any = None
    mesh: Any = None
    rules: Optional[dict] = None
    layout: Any = None


def param_specs(cfg: ModelConfig) -> dict:
    """``init_model``'s parameters in the training layout, as ``meta``
    tensors: the initializers run on fake tensors, so nothing is
    allocated even for a full config."""
    return convert.stack_params(serving_param_specs(cfg))


def serving_param_specs(cfg: ModelConfig) -> dict:
    """``init_model``'s parameters (the per-repeat layout serving reads)
    as ``meta`` tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = model_lib.init_model(cfg, generator=torch.Generator())
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
                    device=None, mesh=None, layout: str = "tp",
                    sequence_parallel: bool = False
                    ) -> tuple[Callable, StepSpecs]:
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
    leave them stale).

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`): the sharded step
    (:func:`make_sharded_train_step`); ``device`` is then the mesh's."""
    if mesh is not None:
        return make_sharded_train_step(
            cfg, mesh, batch_size=batch_size, seq_len=seq_len, lr_fn=lr_fn,
            grad_wire=grad_wire, microbatch=microbatch, donate=donate,
            layout=layout, sequence_parallel=sequence_parallel)
    _no_mesh(layout, sequence_parallel)
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
                      seq_len: int, mesh=None, layout: str = "tp"
                      ) -> Callable:
    """``prefill(params, batch, caches) -> (last logits (B, V), caches)``:
    forward the whole prompt, fill the caches, return the last
    position's logits.  ``seq_len`` counts every position: a vlm
    prompt's patches and tokens (``data.pipeline.batch_shapes``).
    ``mesh``: the sharded step (:func:`make_sharded_serving_steps`)."""
    if mesh is not None:
        return make_sharded_serving_steps(cfg, mesh, batch_size=batch_size,
                                          seq_len=seq_len,
                                          layout=layout)[0]
    _no_mesh(layout, False)
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
                     cache_len: int, mesh=None, layout: str = "tp"
                     ) -> Callable:
    """``decode(params, tokens, caches) -> (next tokens, logits, caches)``:
    one greedy token against ``cache_len``-long caches (the attention
    caches' length; a recurrent state has none, only a batch axis).
    ``mesh``: the sharded step (:func:`make_sharded_serving_steps`)."""
    if mesh is not None:
        return make_sharded_serving_steps(cfg, mesh, batch_size=batch_size,
                                          seq_len=cache_len,
                                          layout=layout)[1]
    _no_mesh(layout, False)
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


# ---------------------------------------------------------------------------
# the sharded steps
# ---------------------------------------------------------------------------
def _no_mesh(layout: str, sequence_parallel: bool) -> None:
    if layout != "tp" or sequence_parallel:
        raise ValueError(f"layout={layout!r}, sequence_parallel="
                         f"{sequence_parallel}: a layout needs a mesh")


def sharded_rules(cfg: ModelConfig, mesh, *, batch_size: Optional[int],
                  layout: str = "tp",
                  sequence_parallel: bool = False) -> dict:
    """The reference's ``_rules_for``: ``default_rules`` for the mesh
    (``layout="sp"`` splits the sequence over ``model``;
    ``sequence_parallel`` adds Megatron-SP's split of it to ``"tp"``),
    the batch replicated where the data axes do not divide it."""
    if set(mesh.shape) - {"pod", "data", "model"}:
        raise ValueError(f"sharded steps: mesh axes {mesh.axes}; the LM "
                         "mesh's are data, model (and pod)")
    rules = default_rules(multi_pod="pod" in mesh.shape, fsdp=cfg.fsdp,
                          sequence_parallel=sequence_parallel, layout=layout)
    dp = tuple(a for a in rules["batch"] if a in mesh.shape)
    if batch_size is not None and batch_size % mesh.count(dp):
        rules["batch"] = None        # latency-bound serving: TP does the
    return rules                     # work, the data axes replicate


def _split_batch(L, x) -> list:
    """A global batch leaf's rows for each position (its data shard's),
    on the position's device."""
    mesh = L.mesh
    x = torch.as_tensor(x)
    n = mesh.count(L.dp)
    if x.shape[0] % n:
        raise ValueError(f"sharded step: a batch of {x.shape[0]} rows over "
                         f"{n} data shards")
    b = x.shape[0] // n
    return [x.narrow(0, mesh.rank(i, L.dp) * b, b).to(dev)
            for i, dev in enumerate(mesh.devices)]


def _split_inputs(L, batch: dict) -> dict:
    """Every leaf of a global batch split by :func:`_split_batch`: a dict
    of per-position lists."""
    return {key: _split_batch(L, x) for key, x in batch.items()}


def _rep_axes(mesh, spec) -> tuple:
    """The mesh axes ``spec`` does not split: a leaf is replicated over
    them."""
    used = {a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)}
    return tuple(a for a in mesh.axes if a not in used)


def _canonical(mesh, rep: tuple) -> list:
    """One position of each replica group over ``rep``: index 0 there."""
    return [i for i in range(mesh.size)
            if all(mesh.coords(i)[a] == 0 for a in rep)]


def _check_trees(what: str, trees, mesh) -> None:
    if not isinstance(trees, (list, tuple)) or len(trees) != mesh.size:
        raise ValueError(f"{what}: one tree a mesh position ({mesh.size} "
                         f"of them), got a {type(trees).__name__}")
    for i, (t, dev) in enumerate(zip(trees, mesh.devices)):
        wrong = {str(x.device) for x in leaves(t)
                 if isinstance(x, torch.Tensor) and x.device != dev}
        if wrong:
            raise ValueError(f"{what}: position {i}'s leaves on "
                             f"{sorted(wrong)}, the mesh puts it on {dev}")


def make_sharded_train_step(cfg: ModelConfig, mesh, *, batch_size: int,
                            seq_len: int, lr_fn=None,
                            grad_wire: str = "bf16",
                            microbatch: Optional[int] = None,
                            donate: bool = True, layout: str = "tp",
                            sequence_parallel: bool = False
                            ) -> tuple[Callable, StepSpecs]:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` over ``mesh``: ``params`` and ``opt_state`` lists with one
    tree a position, in the specs' layout (``specs.params_sh``,
    ``specs.opt_state_sh``: ``convert.shard_params`` of the global
    training-layout trees), ``batch`` the global batch.  Metrics (on the
    mesh's first device) as the one-device step's.

    In the reference's order: each microbatch's gradients (autograd
    through the whole sharded step; a ZeRO-3 leaf's data-parallel sum in
    its gather's backward), the sum of each leaf's parts over the axes it
    is replicated on, both in bf16 under ``grad_wire="bf16"`` (each
    data shard's gradient rounded to bf16 before the reduction over the
    data axes, so bf16 is what crosses the wire; its parts over the
    other axes, tensor-parallel partial sums that the reference adds in
    f32 inside its backward, summed in f32 first), the f32 accumulation
    over microbatches, the clip at global norm 1.0 (the sum of squares
    over one copy of each block), and the optimizer on each position's
    blocks (Adafactor's row, column and RMS means summed over the axes
    that split them).

    ``layout="sp"`` splits the sequence over ``model`` (no tensor
    parallelism); ``sequence_parallel=True`` at ``"tp"`` is Megatron-SP
    (:mod:`repro_torch.models.sharded`).  Raises as the one-device step
    does."""
    if cfg.tina_lowering == "kernel":
        raise ValueError(
            "make_train_step: tina_lowering='kernel' has no gradient (the "
            "reference cannot differentiate its 'pallas' lowering either); "
            "train at 'native' or 'conv'")
    if grad_wire not in ("bf16", "none"):
        raise ValueError(f"grad_wire {grad_wire!r}: 'bf16' or 'none'")
    rules = sharded_rules(cfg, mesh, batch_size=batch_size, layout=layout,
                          sequence_parallel=sequence_parallel)
    lr_fn = lr_fn or warmup_cosine(3e-4, 2000, 100_000)
    opt = make_optimizer(cfg, lr_fn)
    pspecs = param_specs(cfg)
    ospecs = opt.init(pspecs)
    specs = StepSpecs(
        params=pspecs, opt_state=ospecs,
        batch=input_specs(cfg, batch_size, seq_len),
        params_sh=shr.step_param_specs(pspecs, cfg, mesh, rules),
        compute_sh=shr.step_param_specs(pspecs, cfg, mesh, rules,
                                        compute=True),
        mesh=mesh, rules=rules)
    specs.opt_state_sh = shr.step_opt_state_specs(ospecs, specs.params_sh)
    L = specs.layout = sharded.make_layout(cfg, mesh, rules, specs.compute_sh)
    wire = torch.bfloat16 if grad_wire == "bf16" else None
    k = microbatch or 1
    keys = [key for key, _ in flatten_with_path(pspecs)]
    sflat = dict(flatten_with_path(specs.params_sh,
                                   is_leaf=lambda x: isinstance(x, PartitionSpec)))
    rep = {key: _rep_axes(mesh, sflat[key]) for key in keys}
    # the wire's sum runs over the data axes; a replicated leaf's parts
    # over the others (tensor-parallel partial sums) meet in f32 first
    outer = {key: tuple(a for a in rep[key] if a in L.dp) for key in keys}
    inner = {key: tuple(a for a in rep[key] if a not in L.dp)
             for key in keys}
    dev0 = mesh.devices[0]
    block_mean = _block_mean(mesh, specs)
    want = set(specs.batch)

    def grads_of(params, batch):
        trees = [map_tree(lambda t: t.detach().requires_grad_(), p)
                 for p in params]
        diff = [leaves(t) for t in trees]
        with torch.enable_grad():
            W = sharded.Weights(trees, mesh, specs.params_sh,
                                specs.compute_sh, grad_dtype=wire)
            total, metrics = sharded.loss_fn(L, W, batch)
            gs = torch.autograd.grad(total, [x for d in diff for x in d],
                                     allow_unused=True)
        n = len(keys)
        out = [[None] * n for _ in range(mesh.size)]
        with torch.no_grad():
            for j, key in enumerate(keys):
                col = []
                for i in range(mesh.size):
                    g = gs[i * n + j]
                    col.append(torch.zeros_like(diff[i][j]) if g is None
                               else g)
                if wire is not None and col[0].dtype == torch.float32:
                    col = coll.all_reduce(col, mesh, inner[key])
                    col = coll.all_reduce([g.to(wire) for g in col], mesh,
                                          outer[key])
                else:
                    col = coll.all_reduce(col, mesh, rep[key])
                for i in range(mesh.size):
                    out[i][j] = col[i].float()
        return out, {key: v.detach() for key, v in metrics.items()}

    def clip(grads):
        sq = []
        for j, key in enumerate(keys):
            for i in _canonical(mesh, rep[key]):
                sq.append(torch.sum(torch.square(grads[i][j])).to(dev0))
        norm = torch.sqrt(sum(sq))
        scale = torch.clamp(1.0 / torch.clamp(norm, min=1e-12), max=1.0)
        for i, dev in enumerate(mesh.devices):
            s_i = scale.to(dev)
            for g in grads[i]:
                g.mul_(s_i)
        return norm

    def train_step(params, opt_state, batch):
        _check_trees("train_step params", params, mesh)
        _check_trees("train_step opt_state", opt_state, mesh)
        bad = _serving_copies(params[0])
        if bad:
            raise ValueError(
                f"train_step: params carry serving copies {bad[:3]} "
                "(models.model.prepare); train on unprepared params")
        if not donate:
            params = [map_tree(torch.clone, p) for p in params]
            opt_state = [map_tree(torch.clone, o) for o in opt_state]
        batch = {key: torch.as_tensor(v) for key, v in batch.items()
                 if key in want}
        rows = next(iter(batch.values())).shape[0]
        if rows % k:
            raise ValueError(f"train_step: a batch of {rows} rows in {k} "
                             "microbatches")
        m = rows // k
        grads = metrics = None
        for mb in range(k):
            g, met = grads_of(params, _split_inputs(
                L, {key: v[mb * m:(mb + 1) * m] for key, v in batch.items()}))
            if grads is None:
                grads, metrics = g, met
            else:
                for a, b in zip(grads, g):
                    for x, y in zip(a, b):
                        x.add_(y)
                metrics = {key: metrics[key] + met[key] for key in met}
        if k > 1:
            for a in grads:
                for x in a:
                    x.div_(k)
            metrics = {key: v / k for key, v in metrics.items()}
        gnorm = clip(grads)
        if opt.update_blocks is not None:
            opt.update_blocks([unflatten(p, g) for p, g in zip(params, grads)],
                              opt_state, params, block_mean)
        else:
            for i, dev in enumerate(mesh.devices):
                with sharded.device_ctx(dev):
                    opt.update(unflatten(params[i], grads[i]), opt_state[i],
                               params[i])
        return params, opt_state, {**metrics, "grad_norm": gnorm.detach()}

    return train_step, specs


def _block_mean(mesh, specs):
    """``optim.adafactor``'s ``mean`` hook over a sharded step's
    per-position blocks: a mean along a parameter axis (or over all of
    them) that mesh axes split is the sum over those axes divided by the
    whole leaf's count; over an unsplit axis, the block's own mean."""
    sflat = [spec for _, spec in flatten_with_path(
        specs.params_sh, is_leaf=lambda x: isinstance(x, PartitionSpec))]
    gshape = [t.shape for t in leaves(specs.params)]

    def mean(j, xs, dim, axis):
        shape = gshape[j]
        if axis is None:
            axes = tuple(a for a in mesh.axes
                         if a not in _rep_axes(mesh, sflat[j]))
            n = shape.numel()
        else:
            ent = tuple(sflat[j]) + (None,) * (len(shape) - len(sflat[j]))
            axes, n = ent[axis], shape[axis]
        if not axes:
            return [x.mean() if dim is None else x.mean(dim) for x in xs]
        sums = [x.sum() if dim is None else x.sum(dim) for x in xs]
        return [x / n for x in coll.all_reduce(sums, mesh, axes)]
    return mean


def make_sharded_serving_steps(cfg: ModelConfig, mesh, *, batch_size: int,
                               seq_len: int, layout: str = "tp"
                               ) -> tuple[Callable, Callable]:
    """``(prefill, decode)`` over ``mesh``, each with a ``specs``
    attribute (:class:`StepSpecs`: ``params_sh`` the compute layout of
    ``init_model``'s per-repeat tree, which serving keeps its weights in
    (no ZeRO-3 gather per token); ``layout``).

    ``prefill(params, batch, caches) -> (last logits (B, V), caches)``
    and ``decode(params, tokens (B,), caches) -> (next tokens, logits,
    caches)``, as the one-device steps: ``params`` one tree a position
    (``convert.shard_params(params, mesh, specs.params_sh, copy=False)``,
    then ``models.model.prepare`` on each for the kernel lowering),
    ``caches`` from :func:`init_sharded_caches`, written in place; the
    batch and tokens global, the logits and tokens global on the mesh's
    first device (the vocab blocks gathered)."""
    rules = sharded_rules(cfg, mesh, batch_size=batch_size, layout=layout)
    pspecs = serving_param_specs(cfg)
    compute = shr.step_param_specs(pspecs, cfg, mesh, rules, compute=True)
    L = sharded.make_layout(cfg, mesh, rules, compute)
    specs = StepSpecs(params=pspecs, params_sh=compute, compute_sh=compute,
                      batch=input_specs(cfg, batch_size, seq_len),
                      mesh=mesh, rules=rules, layout=L)

    want = {k: tuple(specs.batch[k].shape)
            for k in _INPUTS.get(cfg.family, ("tokens",))}

    def prefill(params, batch, caches):
        _check_trees("prefill params", params, mesh)
        for k, shape in want.items():
            _check(f"prefill {k}", batch[k].shape, shape)
        logits = sharded.forward_cached(
            L, sharded.Weights(params, mesh),
            _split_inputs(L, {k: batch[k] for k in want}), caches)
        return logits, caches

    def decode(params, tokens, caches):
        _check_trees("decode params", params, mesh)
        tokens = torch.as_tensor(tokens)
        _check("decode tokens", tokens.shape, (batch_size,))
        logits = sharded.forward_cached(
            L, sharded.Weights(params, mesh),
            _split_inputs(L, {"tokens": tokens[:, None]}), caches)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, caches

    prefill.specs = decode.specs = specs
    return prefill, decode


def init_sharded_caches(specs: StepSpecs, batch: int, max_len: int) -> list:
    """A sharded serving step's caches: one tree a position, its rows of
    the batch and its KV heads, on its device."""
    return sharded.init_caches(specs.layout, batch, max_len)


__all__ = ["StepSpecs", "param_specs", "serving_param_specs",
           "value_and_grad", "make_train_step", "make_prefill_step",
           "make_decode_step", "make_sharded_train_step",
           "make_sharded_serving_steps", "init_sharded_caches",
           "sharded_rules"]
