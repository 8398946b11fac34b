"""Parameter / optimizer-state / batch / cache sharding rules, the port
of the reference's ``repro.distributed.sharding``.

One ordered regex table maps every parameter path to a logical spec;
logical names resolve through a rule set
(:func:`repro_torch.partitioning.default_rules`).  The same table serves
optimizer state (AdamW's m/v mirror params; Adafactor's vr/vc drop the
corresponding factored axis).

Each function returns a tree of legalized
:class:`~repro_torch.partitioning.PartitionSpec` aligned with its input
(the port's nested dicts and lists, leaves anything with a ``shape``:
tensors, ``meta`` tensors; paths as :mod:`repro_torch.tree` keys them,
``stack/sub0/attn/wq/w`` in the training layout).  ``mesh`` is anything
with a ``shape`` dict of axis sizes (``launch.mesh.BatchMesh``) or such a
dict itself; only its sizes are read.

The sharded steps (:mod:`repro_torch.distributed.step`) read
:func:`param_shardings` through :func:`step_param_specs` (which also
gives each shard's compute layout) and derive the
optimizer state's specs from it (:func:`step_opt_state_specs`); they
split the batch by the rules' ``batch`` axes and hold caches in
:mod:`repro_torch.models.sharded`'s per-position layout.
:func:`opt_state_shardings`, :func:`batch_shardings` and
:func:`cache_shardings` are the reference's functions, kept and tested
against it, but no step of the port reads them.

TP legality note: specs shard *flattened feature dims* (e.g. the
``h*hd`` output of wq), never the per-head axis, so head counts that
don't divide the model axis (qwen2: 28 heads on 16-way TP) still shard
evenly — 3584 = 16 x 224.  The sharded steps keep those flat blocks and
move activations onto whole heads where they attend
(:mod:`repro_torch.models.sharded`).
"""
from __future__ import annotations

import math
import re

from repro_torch.models.config import ModelConfig
from repro_torch.partitioning import P, PartitionSpec, logical_to_spec
from repro_torch.tree import flatten_with_path, map_with_path

# (path regex, logical spec for the *trailing* dims) — first match wins.
# "fsdp" resolves to the data axis only when cfg.fsdp (rules handle it).
_PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings: vocab-parallel, embed over fsdp
    (r".*embed/table$",        ("vocab", "fsdp")),
    (r".*head/w$",             ("fsdp", "vocab")),
    # attention
    (r".*(wq|wk|wv)/w$",       ("fsdp", "tp")),
    (r".*(wq|wk|wv)/b$",       ("tp",)),
    (r".*wo/w$",               ("tp", "fsdp")),
    (r".*wo/b$",               (None,)),
    # MoE experts: expert axis over model (EP), embed over fsdp
    (r".*(w_up|w_gate)$",      ("expert", "fsdp", None)),
    (r".*w_down$",             ("expert", None, "fsdp")),
    (r".*router/w$",           (None, None)),
    # dense MLP (also shared/dense-residual expert MLPs)
    (r".*(up|gate)/w$",        ("fsdp", "tp")),
    (r".*down/w$",             ("tp", "fsdp")),
    # recurrentgemma RG-LRU
    (r".*(in_x|in_gate|w_r|w_i)/w$", ("fsdp", "tp")),
    (r".*rec/out/w$",          ("tp", "fsdp")),
    (r".*conv_taps$",          (None, "tp")),
    (r".*/lambda$",            ("tp",)),
    # rwkv6
    (r".*(wr|wk|wv|wg)/w$",    ("fsdp", "tp")),
    (r".*(tm|cm)/wo/w$",       ("tp", "fsdp")),
    (r".*mix_w1$",             ("fsdp", None)),
    (r".*mix_w2$",             (None, None, "fsdp")),
    (r".*td_w1$",              ("fsdp", None)),
    (r".*td_w2$",              (None, "fsdp")),
    (r".*(mu_base|mu_rwkvg|w0|u|ln_x)$", None),  # small: replicated
    # frontends
    (r".*frontend/proj/w$",    (None, "fsdp")),
    (r".*conv_pos$",           (None, "fsdp")),
]


def _sizes(mesh) -> dict:
    """The mesh's {axis: size}."""
    return dict(getattr(mesh, "shape", mesh))


def _shape(leaf) -> tuple:
    """A leaf's shape; a host number (a cache's position counter) has
    none."""
    return tuple(getattr(leaf, "shape", ()))


def legalize(spec: PartitionSpec, shape: tuple, mesh) -> PartitionSpec:
    """Make a spec legal on ``mesh``: (a) drop mesh axes whose size
    doesn't divide the dim (hubert's 504-entry vocab can't shard 16-way);
    (b) drop axes already used by an earlier dim (the fsdp layout maps
    both 'vocab' and 'fsdp' to the model axis — first occurrence wins)."""
    sizes = _sizes(mesh)
    out = []
    used: set = set()
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a not in used)
        if not axes:
            out.append(None)
            continue
        size = math.prod(sizes[a] for a in axes)
        if dim % size != 0:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    return P(*out)


def spec_for(path: str, ndim: int, rules: dict) -> PartitionSpec:
    """Logical spec for a parameter path, resolved through ``rules``.
    Leading axes not covered by the rule (the stack's ``reps`` axis) are
    unsharded."""
    if ndim == 0:
        return P()
    for pat, logical in _PARAM_RULES:
        if re.match(pat, path):
            if logical is None:
                return P(*([None] * ndim))
            spec = logical_to_spec(logical, rules)
            if len(spec) > ndim:       # rank-reduced (e.g. bias-less match)
                spec = P(*spec[-ndim:])
            pad = ndim - len(spec)
            return P(*([None] * pad + list(spec)))
    return P(*([None] * ndim))


def param_shardings(params_shape, cfg: ModelConfig, mesh, rules: dict):
    """Tree of legalized specs aligned with ``params_shape`` (the
    training layout's parameters or their ``meta`` specs)."""
    def f(path, leaf):
        shape = _shape(leaf)
        return legalize(spec_for(path, len(shape), rules), shape, mesh)
    return map_with_path(f, params_shape)


def opt_state_shardings(opt_state_shape, cfg: ModelConfig, mesh,
                        rules: dict):
    """AdamW m/v mirror the param spec; Adafactor's vr drops the last
    axis, vc the second-to-last.  Paths look like
    ``m/stack/sub0/attn/wq/w`` or ``s/stack/.../w/vr``."""
    def f(path, leaf):
        shape = _shape(leaf)
        ndim = len(shape)
        head, _, rest = path.partition("/")
        if head in ("m", "v"):
            spec = spec_for(rest, ndim, rules)
        elif head == "s":
            base, _, kind = rest.rpartition("/")
            pspec = spec_for(base, ndim + (1 if kind in ("vr", "vc") else 0),
                             rules)
            if kind == "vr":
                spec = P(*pspec[:-1])
            elif kind == "vc":
                spec = P(*(list(pspec[:-2]) + [pspec[-1]]))
            else:
                spec = P(*pspec[:ndim]) if len(pspec) >= ndim else pspec
        else:                                    # count, ef residuals, ...
            spec = P(*([None] * ndim))
        return legalize(spec, shape, mesh)
    return map_with_path(f, opt_state_shape)


def batch_shardings(batch_shape, mesh, rules: dict):
    """Every batch leaf shards its leading (batch) dim over the DP axes."""
    dp = rules.get("batch")

    def f(_, leaf):
        shape = _shape(leaf)
        return legalize(P(*([dp] + [None] * (len(shape) - 1))), shape, mesh)
    return map_with_path(f, batch_shape)


def cache_shardings(cache_shape, cfg: ModelConfig, mesh, rules: dict):
    """KV caches: (B, S, Hkv, hd) -> (batch, None, tp-if-divisible, None).
    Recurrent states: (B, ...) -> batch on dim 0, tp on the last (width)
    dim when divisible.  Position counters replicated.  The port keeps
    one cache per repeat of the stack (``models.model.init_caches``), so
    a leaf's batch dim is always its first: the spec of the reference's
    stacked leaf without its leading ``reps`` entry."""
    model_size = _sizes(mesh).get("model", 1)
    dp = rules.get("batch")
    tp = rules.get("tp")

    def f(path, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0:
            return P()
        spec = [None] * nd
        spec[0] = dp
        if path.endswith(("/k", "/v")) and nd >= 4:
            if shape[2] % model_size == 0:
                spec[2] = tp
        elif path.endswith("/S"):
            pass                      # rwkv wkv state: batch-sharded only
        elif nd >= 2 and shape[-1] % model_size == 0 \
                and not path.endswith("pos"):
            spec[-1] = tp
        return legalize(P(*spec), shape, mesh)
    return map_with_path(f, cache_shape)


# ---------------------------------------------------------------------------
# the sharded steps' layouts (repro_torch.distributed.step)
# ---------------------------------------------------------------------------
def kv_replicated(cfg: ModelConfig, mesh, rules: dict) -> bool:
    """Whether the KV heads are replicated over the tensor-parallel axis:
    its degree does not divide them (each shard then reads the KV heads
    its query heads use, out of the whole ``wk``/``wv``)."""
    n = _tp_degree(mesh, rules)
    return n > 1 and cfg.n_kv_heads % n != 0


def _drop(spec: PartitionSpec, axes) -> PartitionSpec:
    """``spec`` without the mesh axes ``axes`` in any entry."""
    names = set((axes,) if isinstance(axes, str) else axes)
    out = []
    for e in spec:
        kept = tuple(a for a in ((e,) if isinstance(e, str) else e or ())
                     if a not in names)
        out.append(kept if kept else None)
    return P(*out)


# the compute layout's own cuts under tensor parallelism (rwkv6): the
# time mix's per-channel and per-head leaves, which the reference
# replicates, cut to a shard's heads where the degree divides the heads
# (else they stay whole and each shard reads its heads' part: the
# shards' head ranges are not equal blocks, models.sharded.head_ranges);
# the channel mix's value map split on its d_ff rows, Megatron's
# row-parallel form (the reference's (wq|wk|wv)/w rule stores it split
# on its output columns)
_COMPUTE_TP: list[tuple[str, tuple, bool]] = [
    (r".*tm/(w0|ln_x)$",       ("tp",), True),
    (r".*tm/u$",               ("tp", None), True),
    (r".*tm/td_w2$",           (None, "tp"), True),
    (r".*cm/wv/w$",            ("tp", None), False),
]


def _tp_degree(mesh, rules: dict) -> int:
    tp = rules.get("tp")
    if tp is None:
        return 1
    return math.prod(_sizes(mesh)[a] for a in
                     ((tp,) if isinstance(tp, str) else tp))


def _compute_tp(path: str, leaf, spec, rules: dict, mesh, heads_split: bool):
    shape = _shape(leaf)
    for pat, logical, per_head in _COMPUTE_TP:
        if re.match(pat, path):
            if per_head and not heads_split:
                return spec
            cut = logical_to_spec(logical, rules)
            return legalize(P(*([None] * (len(shape) - len(cut))
                                + list(cut))), shape, mesh)
    return spec


def step_param_specs(tree, cfg: ModelConfig, mesh, rules: dict, *,
                     compute: bool = False):
    """The specs a sharded step keeps a parameter tree in: the
    reference's (:func:`param_shardings`), except where the KV heads are
    replicated (:func:`kv_replicated`): there ``wk``/``wv`` are whole
    over the tensor-parallel axis, since the reference's split of their
    flat ``hkv * hd`` axis does not fall on heads.  ``compute`` gives the
    layout each shard computes in: the same without the ZeRO-3 axes
    (rules' ``"fsdp"``), which a training step gathers before use and a
    serving step never splits, and, under tensor parallelism, rwkv6's
    cuts of :data:`_COMPUTE_TP` (a training step reshards those leaves
    from the stored specs at their use).  Every other leaf keeps the
    reference's flat blocks, also where the degree does not divide the
    heads (qwen2's 28 on 16 ranks: 224 columns a rank, 1.75 heads)."""
    is_spec = lambda x: isinstance(x, PartitionSpec)
    if compute:
        rules = {**rules, "fsdp": None}
    specs = param_shardings(tree, cfg, mesh, rules)
    if compute and rules.get("tp"):
        flat = dict(flatten_with_path(tree))
        split = (cfg.d_model // cfg.rwkv_head_size) \
            % _tp_degree(mesh, rules) == 0
        specs = map_with_path(
            lambda path, spec: _compute_tp(path, flat[path], spec, rules,
                                           mesh, split), specs,
            is_leaf=is_spec)
    if not kv_replicated(cfg, mesh, rules):
        return specs
    kv = re.compile(r"(^|.*/)attn/(wk|wv)/")
    return map_with_path(
        lambda path, spec: _drop(spec, rules["tp"]) if kv.match(path)
        else spec, specs, is_leaf=is_spec)


def step_opt_state_specs(opt_state_shape, param_specs):
    """A sharded step's optimizer-state specs, each the block of its
    parameter's spec (:func:`step_param_specs`): AdamW's m/v that spec,
    Adafactor's vr without its last entry, vc without the one before,
    v that spec; counters replicated.  (The reference's
    :func:`opt_state_shardings` legalizes each state leaf on its own
    shape, which can split a factor the parameter leaves whole; a step
    that updates each position's blocks needs them aligned.)"""
    flat = dict(flatten_with_path(param_specs,
                                  is_leaf=lambda x: isinstance(x,
                                                               PartitionSpec)))

    def f(path, leaf):
        head, _, rest = path.partition("/")
        if head in ("m", "v"):
            return flat[rest]
        if head == "s":
            base, _, kind = rest.rpartition("/")
            spec = tuple(flat[base])
            if kind == "vr":
                return P(*spec[:-1])
            if kind == "vc":
                return P(*(spec[:-2] + spec[-1:]))
            return P(*spec)
        return P(*([None] * len(_shape(leaf))))
    return map_with_path(f, opt_state_shape)

__all__ = ["legalize", "spec_for", "param_shardings", "opt_state_shardings",
           "batch_shardings", "cache_shardings", "kv_replicated",
           "step_param_specs", "step_opt_state_specs"]
