"""Measurement-based autotuner: lowering choice AND kernel block
configs, with a persistent on-disk cache.

For each graph node the planner asks :func:`pick`, which times every
supported candidate on the node's *actual* shapes and dtypes (one-node
runs on the plan's device, best of a few repeats) and returns the
fastest ``(lowering, block_config)``.  ``kernel`` candidates are
expanded through the kernel's own
:class:`repro_torch.kernels.tune.TuneSpace` -- the compiled tiles the
kernel's validity predicate admits -- so an invalid tiling is never
measured.  Early pruning keeps the search cheap: a candidate slower than
the incumbent after its first timed repeat is abandoned.

Timing: on a CUDA device each call is timed with CUDA events on the
current stream, after a warm-up call (which also absorbs a kernel
library's build at its first launch); on the CPU with ``perf_counter``.
A candidate that does not fit the shapes (``ValueError`` from a tune
space or a wrapper's shape check) measures as infinitely slow; any other
error -- a kernel that fails to build or launch -- propagates, so a
broken kernel can never be hidden behind a ``native`` winner.

Winners persist to a JSON cache (schema v2) so the measurement cost is
paid once per (op, shapes, dtype, card) -- across processes, not just per
session.  The key's backend is the card (``"cuda:<device name>"``) or
``"cpu"``, so a winner measured on one card is not taken on another.
Under a mesh the tuner sees the per-shard problem: a sharded compile
tunes the per-shard plan of the mesh's first device first (its keys
carry the per-shard batch), and the other devices' per-shard plans read
those winners from the cache -- the reason a mesh of cards with
different names raises (:mod:`repro_torch.launch.mesh`).
v1 caches (flat ``key -> {lowering, ...}`` maps) are migrated on load;
their entries keep their lowering and fall back to default block
configs.

Environment:
  ``TINA_AUTOTUNE``        ``on`` (default: measure & persist),
                           ``cached`` (never measure: cache hit or
                           fixed defaults -- deterministic, for CI and
                           production serving), ``off`` (fixed defaults,
                           no cache reads at all).  The fixed default
                           is the kernel at its default tile wherever
                           the op has one, else ``native``.
  ``TINA_AUTOTUNE_CACHE``  cache file path (default
                           ``~/.cache/tina/autotune_torch.json``: this
                           package's own file, never the JAX package's).

The in-process cache mirror is invalidated when the file's mtime
changes, so concurrent tuner processes pick up each other's entries
without a restart.

CLI::

    PYTHONPATH=src python -m repro_torch.graph.autotune \\
        --pipeline spectrogram --n 512 --repeats 2 [--device cpu]
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import time
import warnings
from typing import Callable, Sequence

import torch

from repro_torch import obs, resolve_device
from repro_torch.obs import faults

SCHEMA_VERSION = 2


def cache_path() -> str:
    return os.environ.get(
        "TINA_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "tina",
                     "autotune_torch.json"))


def mode() -> str:
    """Autotune mode from ``$TINA_AUTOTUNE``: off | cached | on."""
    m = os.environ.get("TINA_AUTOTUNE", "on").strip().lower()
    if m not in ("off", "cached", "on"):
        raise ValueError(
            f"TINA_AUTOTUNE={m!r}: expected off, cached, or on")
    return m


def backend_of(device) -> str:
    """The cache key's backend: ``"cuda:<device name>"`` or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


# path -> {"mtime": int | None, "entries": {key: entry}}
_MEM: dict[str, dict] = {}

# tuner bookkeeping lives on obs counters; stats() is a dict view of
# them (dsp_serve --metrics-interval prints it)
_MEASURED = obs.counter("autotune.measured")
_CACHE_HITS = obs.counter("autotune.cache_hits")
_PRUNED = obs.counter("autotune.pruned")
_STALE = obs.counter("autotune.stale")
_CACHE_CORRUPT = obs.counter("autotune.cache_corrupt")


def stats() -> dict:
    return {"measured": _MEASURED.value, "cache_hits": _CACHE_HITS.value,
            "pruned": _PRUNED.value, "stale": _STALE.value,
            "cache_corrupt": _CACHE_CORRUPT.value}


def _mtime(path: str) -> int | None:
    try:
        return os.stat(path).st_mtime_ns
    except OSError:
        return None


def _quarantine_corrupt(path: str, why: str) -> dict:
    """A cache file that exists but can't be parsed is evidence of a bug
    or a torn write: keep it as ``<path>.bak`` instead of silently
    shadowing it with an empty cache until the next ``_save`` overwrites
    the evidence."""
    _CACHE_CORRUPT.add()
    bak = path + ".bak"
    try:
        os.replace(path, bak)
        action = f"quarantined to {bak}"
    except OSError:
        action = "could not be quarantined (read-only FS?)"
    warnings.warn(
        f"autotune cache {path} is corrupt ({why}); {action}; starting "
        "with a fresh cache", stacklevel=3)
    return {}


def _read_file(path: str) -> dict:
    """Read + migrate a cache file into a flat entries dict.  A missing
    file (or an injected ``cache_io`` fault) is a fresh start; a file
    that *exists* but doesn't parse is quarantined to ``.bak``."""
    try:
        faults.check("cache_io")
        with open(path) as f:
            raw = json.load(f)
    except (OSError, faults.InjectedFault):
        return {}                # no cache (or chaos-injected I/O): fresh
    except ValueError:
        return _quarantine_corrupt(path, "unparseable JSON")
    if not isinstance(raw, dict):
        return _quarantine_corrupt(path, "top level is not a JSON object")
    if raw.get("schema") == SCHEMA_VERSION:
        entries = raw.get("entries", {})
        if not isinstance(entries, dict):
            return _quarantine_corrupt(path, "'entries' is not an object")
        return entries
    # v1: a flat key -> {lowering, ...} map (no schema marker).  Keep the
    # tuned lowering; block configs default until re-measured.
    return {k: {"config": {}, **v}
            for k, v in raw.items() if isinstance(v, dict)}


def _load(path: str) -> dict:
    """Entries for ``path``, reloading whenever the file changed on disk
    (concurrent tuner processes must see each other's merged saves)."""
    mt = _mtime(path)
    slot = _MEM.get(path)
    if slot is None or slot["mtime"] != mt:
        slot = {"mtime": mt, "entries": _read_file(path)}
        _MEM[path] = slot
    return slot["entries"]


def _save(path: str, entries: dict) -> None:
    try:
        faults.check("cache_io")
    except faults.InjectedFault:
        return                   # injected I/O failure: like a read-only
        # FS, tuning stays in memory
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # merge with what's on disk so concurrent tuners (other processes
        # tuning other nodes) don't lose each other's entries to a
        # read-modify-write race; our entries win ties
        merged = {**_read_file(path), **entries}
        entries.update(merged)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump({"schema": SCHEMA_VERSION, "entries": merged}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, path)    # atomic replace: readers never see partials
        _MEM[path] = {"mtime": _mtime(path), "entries": merged}
    except OSError:
        pass                     # read-only FS: tuning stays in memory


def node_key(node, in_avals: Sequence[torch.Tensor], backend: str) -> str:
    shapes = ",".join(f"{tuple(a.shape)}:{a.dtype}" for a in in_avals)
    attrs = ";".join(f"{k}={v}" for k, v in node.attrs)
    return f"{node.op}|{shapes}|{attrs}|{backend}"


# ---------------------------------------------------------------------------
# graph op -> kernel TuneSpace + measurement context, read off the OpDef
# (``tune_space`` / ``qtune_space`` and ``tune_ctx``)
# ---------------------------------------------------------------------------
def tune_ctx(node, in_avals: Sequence[torch.Tensor]) -> dict | None:
    """The shape facts the node's TuneSpace needs (None: nothing tunable)."""
    from repro_torch.core.opdefs import OPDEFS
    d = OPDEFS.get(node.op)
    if d is None or d.tune_ctx is None:
        return None
    return d.tune_ctx(d.bind(node.attr), [tuple(a.shape) for a in in_avals])


def space_for(op: str, precision: str = "f32"):
    """The TuneSpace tuning a graph op's kernel (None: not tunable).
    ``precision="int8"`` answers with the op's integer kernel space
    (``qtune_space``); ops without one are untunable at int8."""
    from repro_torch.core.opdefs import OPDEFS
    d = OPDEFS.get(op)
    if d is None:
        return None
    name = d.qtune_space if precision == "int8" else d.tune_space
    if name is None:
        return None
    from repro_torch.kernels import tune
    return tune.space(name)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------
def _dummy(aval: torch.Tensor, device) -> torch.Tensor:
    """A probe input of ``aval``'s shape and dtype on ``device``: standard
    normal values from a generator seeded 0 on that device (a fresh one
    per input, real part then imaginary part, as the reference draws
    from ``np.random.default_rng(0)``; the values are torch's stream)."""
    gen = torch.Generator(device=device).manual_seed(0)
    shape = tuple(aval.shape)
    x = torch.randn(shape, generator=gen, device=device)
    if aval.dtype.is_complex:
        y = torch.randn(shape, generator=gen, device=device)
        return torch.complex(x, y).to(aval.dtype)
    return x.to(aval.dtype)


def _cuda_of(args) -> torch.device | None:
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.device
    return None


def _timed(fn, args, dev) -> float:
    """Seconds of one call: CUDA events on the current stream of ``dev``,
    or ``perf_counter`` on the CPU."""
    if dev is None:
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def measure(fn, args, *, repeats: int = 3, warmup: int = 1,
            prune_above: float | None = None) -> float:
    """Best-of-N seconds per call of ``fn(*args)`` (min, not median: on a
    contended box spikes inflate the median one-sidedly, and the fastest
    observed run is the least noisy estimate).  The warm-up calls are not
    timed: they build a kernel library at its first launch.

    ``prune_above``: early-pruning threshold -- if the first timed repeat
    is already slower than this (the incumbent's time), skip the rest;
    the candidate can't win.

    A candidate that does not fit these shapes (``ValueError``) or an
    injected ``autotune_measure`` fault measures ``inf``; every other
    error propagates."""
    try:
        faults.check("autotune_measure")
        dev = _cuda_of(args)
        for _ in range(warmup):
            fn(*args)
        if dev is not None:
            torch.cuda.synchronize(dev)
        ts = []
        for i in range(repeats):
            ts.append(_timed(fn, args, dev))
            if i == 0 and prune_above is not None and ts[0] > prune_above:
                _PRUNED.add()
                break
        return float(min(ts))
    except (ValueError, faults.InjectedFault):
        return float("inf")      # candidate doesn't fit these shapes


# a non-default config must beat the default by this margin in the
# playoff to be selected -- hysteresis against measurement noise
PLAYOFF_MARGIN = 0.97


def _playoff(fn_a, fn_b, args, *, repeats: int = 5) -> tuple[float, float]:
    """Interleaved best-of-N head-to-head: alternating calls cancel the
    drift that back-to-back scans are exposed to."""
    dev = _cuda_of(args)
    best_a = best_b = float("inf")
    for _ in range(repeats):
        best_a = min(best_a, _timed(fn_a, args, dev))
        best_b = min(best_b, _timed(fn_b, args, dev))
    return best_a, best_b


def _cfg_label(lowering: str, cfg: dict) -> str:
    if not cfg:
        return lowering
    inner = ",".join(f"{k}={v}" for k, v in sorted(cfg.items()))
    return f"{lowering}[{inner}]"


def _times_us(times: dict) -> dict:
    return {k: round(v * 1e6, 1) for k, v in times.items()
            if math.isfinite(v)}


def _where(device, backend) -> tuple[torch.device, str]:
    dev = resolve_device(device)
    return dev, backend or backend_of(dev)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------
def pick(graph, node, avals: dict, *, device=None, backend: str = None,
         lowerings: Sequence[str] | None = None, repeats: int = 3,
         path: str | None = None,
         precision: str = "f32") -> tuple[str, dict]:
    """Fastest (lowering, block_config) for ``node`` at its inferred
    shapes (``avals``: name -> meta tensor, as ``plan.infer`` gives
    them), measured on ``device`` (default ``"cuda"``) and cached.

    ``lowerings`` restricts the lowering search (e.g. ``("kernel",)`` to
    tune only block configs for a fixed lowering).
    ``precision="int8"`` (for ops with a quantized impl) searches the
    integer path instead: candidates from the OpDef's ``q_lowerings``,
    kernel configs from its ``qtune_space``, and winners under a
    ``|prec=int8``-suffixed key.  Honours ``$TINA_AUTOTUNE``: off ->
    fixed defaults, cached -> cache hit or defaults (never measures),
    on -> measure & persist.  The fixed default is the kernel with its
    default tile wherever ``kernel`` is a candidate (an unmeasured node
    never hides its kernel behind ``native``), else ``native``.
    """
    from repro_torch.core.opdefs import OPDEFS
    from repro_torch.graph.plan import apply_node

    dev, backend = _where(device, backend)
    d = OPDEFS[node.op]
    integer = precision == "int8" and d.qimpl is not None
    supported = d.q_lowerings if integer else d.lowerings
    cands = [c for c in (lowerings or supported) if c in supported]
    if not cands:
        return "native", {}

    in_avals = [avals[i] for i in node.inputs]
    ctx = tune_ctx(node, in_avals)
    space = space_for(node.op, precision) if ctx is not None else None
    # fixed-defaults fallback (off, a cached miss, every candidate inf):
    # the kernel at its default tile where there is one, and always
    # inside the caller's candidate set
    default = (next((c for c in ("kernel", "native") if c in cands),
                    cands[0]), {})

    # nothing to search: one lowering and no tunable kernel configs
    kernel_tunable = space is not None and "kernel" in cands
    if len(cands) == 1 and not (kernel_tunable and cands[0] == "kernel"):
        return cands[0], {}

    m = mode()
    if m == "off":
        return default

    path = path or cache_path()
    cache = _load(path)
    key = node_key(node, in_avals, backend)
    if lowerings is not None and list(lowerings) != list(supported):
        # a restricted search answers a different question; don't let it
        # collide with (or clobber) the full-auto winner for this node
        key += f"|only={','.join(cands)}"
    if integer:
        key += "|prec=int8"
    hit = cache.get(key)
    if hit and hit.get("lowering") in cands:
        cfg = dict(hit.get("config") or {})
        if cfg and space is not None:
            try:
                space.check(cfg, ctx)
            except ValueError:
                # stale entry: the kernel's TuneSpace changed since it was
                # written -- fall through to defaults / re-measurement
                hit, cfg = None, {}
                _STALE.add()
        if hit:
            _CACHE_HITS.add()
            return hit["lowering"], cfg
    if m == "cached":
        return default

    _MEASURED.add()
    with obs.span("autotune.pick", cat="autotune", op=node.op,
                  node=node.name):
        args = [_dummy(a, dev) for a in in_avals]
        times: dict[str, float] = {}
        results: list[tuple[float, str, dict]] = []
        fns: dict[str, Callable] = {}  # label -> fn (playoff reuse)
        incumbent = float("inf")

        def _fn(label, lw, cfg):
            if label not in fns:
                fns[label] = (lambda *a, _lw=lw, _cfg=cfg: apply_node(
                    node, a, _lw, _cfg, precision))
            return fns[label]

        default_cfg: dict = {}
        for lw in cands:
            if lw == "kernel" and kernel_tunable:
                # valid candidates only; when the space filters every one,
                # still measure the kernel with its trusted defaults ({})
                cfgs = space.configs(ctx) or ({},)
                # the playoff's hysteresis anchor is the kernel default,
                # when it survived validation (configs() lists it first)
                default_cfg = (dict(cfgs[0])
                               if cfgs[0] and cfgs[0] == space.default(ctx)
                               else {})
            else:
                cfgs = ({},)
            for cfg in cfgs:
                label = _cfg_label(lw, cfg)
                with obs.span("autotune.measure", cat="autotune",
                              op=node.op, candidate=label):
                    t = measure(_fn(label, lw, cfg), args,
                                repeats=repeats, prune_above=incumbent)
                times[label] = t
                results.append((t, lw, dict(cfg)))
                incumbent = min(incumbent, t)

        # collapse the kernel configs to one survivor: re-measure the scan
        # winner against the default tile interleaved, and keep the
        # default unless the winner is decisively faster
        kernel_rs = [r for r in results if r[1] == "kernel"]
        if default_cfg and kernel_rs:
            t_scan, _, cfg_scan = min(kernel_rs, key=lambda r: r[0])
            t_def_scan = next((r[0] for r in kernel_rs
                               if r[2] == default_cfg), float("inf"))
            if (cfg_scan != default_cfg and math.isfinite(t_scan)
                    and math.isfinite(t_def_scan)):
                t_def, t_win = _playoff(
                    _fn(_cfg_label("kernel", default_cfg), "kernel",
                        default_cfg),
                    _fn(_cfg_label("kernel", cfg_scan), "kernel", cfg_scan),
                    args, repeats=max(repeats, 5))
                times["playoff:" + _cfg_label("kernel", default_cfg)] = t_def
                times["playoff:" + _cfg_label("kernel", cfg_scan)] = t_win
                survivor = ((t_win, "kernel", cfg_scan)
                            if t_win < PLAYOFF_MARGIN * t_def
                            else (t_def, "kernel", default_cfg))
            else:
                survivor = (t_scan, "kernel", cfg_scan)
            results = [r for r in results if r[1] != "kernel"] + [survivor]

        best_t, best_lw, best_cfg = min(results, key=lambda r: r[0])
        best = (best_lw, best_cfg) if math.isfinite(best_t) else default
        obs.instant("autotune.winner", cat="autotune", op=node.op,
                    node=node.name, lowering=best[0],
                    config=_cfg_label(best[0], best[1]))
        cache[key] = {"lowering": best[0], "config": best[1],
                      "backend": backend, "times_us": _times_us(times)}
        _save(path, cache)
    return best


# a reduced-precision candidate must be decisively faster than the f32
# winner to be selected (f32 is the numerically safest default)
PRECISION_MARGIN = 0.97


def pick_joint(graph, node, avals: dict, *, device=None,
               backend: str = None,
               lowerings: Sequence[str] | None = None, repeats: int = 3,
               path: str | None = None) -> tuple[str, dict, str]:
    """Fastest (lowering, block_config, precision) for ``node`` -- the
    ``precision="auto"`` search, joint over the op's declared precision
    tiers x the lowering/config search of :func:`pick`.

    Every reduced-precision candidate is checked against the f32 output
    FIRST: one that violates the OpDef's accuracy
    :class:`~repro_torch.core.opdefs.Budget` is rejected before it is
    timed, so ``precision="auto"`` never returns a budget-violating
    winner.  Winners (and the achieved SQNR / max abs error of every
    probed tier, with every time) persist under the node key +
    ``|prec=auto``.  Anything short of ``on`` without a cache hit answers
    f32 (never a reduced tier nobody measured).
    """
    from repro_torch.core.opdefs import OPDEFS
    from repro_torch.graph.plan import apply_node

    dev, backend = _where(device, backend)
    d = OPDEFS[node.op]
    at = d.bind(node.attr)
    prec_cands = [p for p in d.precisions
                  if p != "f32" and d.supports_precision(p, at)]
    in_avals = [avals[i] for i in node.inputs]
    kw = dict(device=dev, backend=backend, lowerings=lowerings,
              repeats=repeats, path=path)

    def f32() -> tuple[str, dict, str]:
        lw, cfg = pick(graph, node, avals, **kw)
        return lw, cfg, "f32"

    if not prec_cands:
        return f32()

    m = mode()
    path = path or cache_path()
    cache = _load(path)
    key = node_key(node, in_avals, backend)
    if lowerings is not None and list(lowerings) != list(d.lowerings):
        only = [c for c in lowerings if c in d.lowerings]
        key += f"|only={','.join(only)}"
    key += "|prec=auto"
    if m != "off":
        hit = cache.get(key)
        if hit and hit.get("precision") in ("f32", *prec_cands):
            _CACHE_HITS.add()
            return (hit["lowering"], dict(hit.get("config") or {}),
                    hit["precision"])
    if m != "on":
        return f32()

    lw32, cfg32, _ = f32()
    _MEASURED.add()
    with obs.span("autotune.pick_joint", cat="autotune", op=node.op,
                  node=node.name):
        args = [_dummy(a, dev) for a in in_avals]

        def _fn(lw, cfg, prec):
            return (lambda *a, _l=lw, _c=cfg, _p=prec:
                    apply_node(node, a, _l, _c, _p))

        try:
            ref = _fn(lw32, cfg32, "f32")(*args)
        except ValueError:
            return f32()         # f32 itself doesn't fit these shapes
        t32 = measure(_fn(lw32, cfg32, "f32"), args, repeats=repeats)
        best = (t32, lw32, cfg32, "f32")
        times = {"f32:" + _cfg_label(lw32, cfg32): t32}
        accuracy: dict[str, dict] = {}
        for p in prec_cands:
            if p == "int8" and d.qimpl is not None:
                # the integer path has its own (lowering x block) search:
                # the torch integer path vs the int8 kernels over the op's
                # qtune_space; its winner is budget-gated and raced below
                lw_p, cfg_p = pick(graph, node, avals, precision="int8",
                                   **kw)
            else:
                lw_p, cfg_p = lw32, cfg32
            fn = _fn(lw_p, cfg_p, p)
            try:
                out = fn(*args)
            except ValueError:
                continue
            budget = d.budget(p)
            if budget is not None:
                ok, achieved = budget.check(ref, out)
                accuracy[p] = {
                    k: (round(v, 2) if math.isfinite(v) else None)
                    for k, v in achieved.items()}
                accuracy[p]["ok"] = ok
                if not ok:
                    continue     # budget violation: never a winner
            del out
            t = measure(fn, args, repeats=repeats, prune_above=best[0])
            times[f"{p}:{_cfg_label(lw_p, cfg_p)}"] = t
            if math.isfinite(t) and t < PRECISION_MARGIN * best[0]:
                best = (t, lw_p, cfg_p, p)
        _, lw, cfg, prec = best
        obs.instant("autotune.winner", cat="autotune", op=node.op,
                    node=node.name, lowering=lw, precision=prec,
                    config=_cfg_label(lw, cfg))
        cache[key] = {"lowering": lw, "config": cfg, "precision": prec,
                      "backend": backend, "accuracy": accuracy,
                      "times_us": _times_us(times)}
        _save(path, cache)
    return lw, cfg, prec


# a chain must be decisively faster unfused to override the fused
# default (noise must not flap plans between shapes)
FUSION_MARGIN = 0.97


def pick_fusion(graph, run, avals: dict, *, device=None, backend: str = None,
                lowering: str = "native", repeats: int = 3,
                path: str | None = None, **_ignored) -> bool:
    """Should this elementwise ``run`` (adjacent nodes the fuser wants
    to collapse) be fused?  Measured verdicts persist in the v2 cache
    like lowering winners, so the decision is paid once per (chain,
    shapes, lowering, card).

    ``TINA_AUTOTUNE=on`` measures the fused node against the member
    chain and persists the verdict; ``cached`` replays a persisted
    verdict or keeps the fused default; ``off`` always fuses.
    """
    from repro_torch.graph.graph import Node
    from repro_torch.graph.plan import apply_node, run_to_steps

    dev, backend = _where(device, backend)
    steps, operand_refs = run_to_steps(run)
    data_in = run[0].inputs[0]
    in_avals = [avals[data_in]] + [avals[o] for o in operand_refs]
    shapes = ",".join(f"{tuple(a.shape)}:{a.dtype}" for a in in_avals)
    chain = "+".join(f"{s[0]}" for s in steps)
    key = f"fusion|{chain}|{shapes}|{lowering}|{backend}"

    def _verdict(fused: bool) -> bool:
        obs.counter("plan.fusion.fused" if fused
                    else "plan.fusion.unfused").add()
        return fused

    m = mode()
    if m == "off":
        return _verdict(True)
    path = path or cache_path()
    cache = _load(path)
    hit = cache.get(key)
    if hit is not None and "fused" in hit:
        _CACHE_HITS.add()
        return _verdict(bool(hit["fused"]))
    if m == "cached":
        return _verdict(True)

    _MEASURED.add()
    with obs.span("autotune.fusion", cat="autotune", chain=chain):
        probe = Node("_fusion_probe", "fused_ew",
                     (data_in, *operand_refs),
                     (("members", tuple(n.name for n in run)),
                      ("steps", steps)))
        args = [_dummy(a, dev) for a in in_avals]

        def fused_fn(*a):
            return apply_node(probe, a, lowering)

        def unfused_fn(*a):
            acc = a[0]
            k = 1
            for n, step in zip(run, steps):
                if step[0] in ("mul", "add"):  # binary: consumes operand
                    acc = apply_node(n, (acc, a[k]), lowering)
                    k += 1
                else:                          # abs2 / scale: unary
                    acc = apply_node(n, (acc,), lowering)
            return acc

        t_fused = measure(fused_fn, args, repeats=repeats)
        t_unfused = measure(unfused_fn, args, repeats=repeats,
                            prune_above=t_fused)
        fused = not (math.isfinite(t_unfused)
                     and t_unfused < FUSION_MARGIN * t_fused)
        cache[key] = {"fused": fused, "lowering": lowering,
                      "backend": backend,
                      "times_us": _times_us({"fused": t_fused,
                                             "unfused": t_unfused})}
        _save(path, cache)
    return _verdict(fused)


# ---------------------------------------------------------------------------
# CLI: tune a built-in pipeline and verify the cache round trip
# ---------------------------------------------------------------------------
def main(argv=None):
    import argparse

    from repro_torch.core.registry import PIPELINES, pipelines
    from repro_torch.graph import autotune as at   # the canonical module:
    # under ``python -m`` this file runs as __main__, but the planner
    # talks to the instance the package imported -- use its stats/caches
    # so the round-trip check is real
    from repro_torch.graph import plan as plan_lib

    ap = argparse.ArgumentParser(
        description="Tune one built-in pipeline's lowerings + block "
                    "configs; verify the on-disk cache round trip.")
    ap.add_argument("--pipeline", default="spectrogram",
                    choices=sorted(p.name for p in pipelines()))
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="where to tune (default cuda; 'cpu' times the "
                         "kernels' plain versions)")
    ap.add_argument("--tune-fusion", action="store_true",
                    help="also measure fused-vs-unfused per elementwise "
                         "chain (fuse='auto') and persist the verdicts")
    ap.add_argument("--precision", default="f32",
                    choices=("f32", "bf16", "int8", "auto"),
                    help="execution tier; 'auto' searches precision "
                         "jointly with lowering x block config, "
                         "budget-gated (verdicts persist in the cache)")
    args = ap.parse_args(argv)

    if at.mode() != "on":
        print(f"[autotune] warning: TINA_AUTOTUNE={at.mode()} -- nothing "
              "will be measured")
    spec = PIPELINES[args.pipeline]
    g = spec.build()
    n = spec.valid_len(args.n)
    fuse = "auto" if args.tune_fusion else None
    opts = plan_lib.CompileOptions(
        lowering="auto", fuse=fuse, precision=args.precision,
        device=args.device, autotune_kwargs={"repeats": args.repeats})
    plan = plan_lib.compile(g, {g.inputs[0]: (n,)}, options=opts)
    print(f"[autotune] {args.pipeline} @ n={n} on {plan.device} "
          f"(cache: {at.cache_path()}, mode: {at.mode()}, "
          f"precision: {args.precision})")
    for name, lw in plan.lowerings.items():
        prec = plan.precisions.get(name, "f32")
        print(f"  {name:24s} -> "
              f"{_cfg_label(lw, plan.configs.get(name, {}))} @ {prec}")
    st = at.stats()
    print(f"[autotune] measured={st['measured']} pruned={st['pruned']} "
          f"cache_hits={st['cache_hits']}")

    # round trip: a fresh in-process cache + a fresh plan cache must
    # resolve every node from disk without re-measuring
    at._MEM.clear()
    plan_lib.clear_cache()
    before = at.stats()["measured"]
    plan2 = plan_lib.compile(g, {g.inputs[0]: (n,)}, options=opts)
    after = at.stats()["measured"]
    ok = (after == before and plan2.lowerings == plan.lowerings
          and plan2.configs == plan.configs
          and plan2.precisions == plan.precisions)
    print(f"[autotune] cache roundtrip: "
          f"{'OK' if ok else 'FAILED'} (re-measured {after - before})")
    if at.mode() == "on" and not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()


__all__ = ["pick", "pick_joint", "pick_fusion", "measure",
           "node_key", "tune_ctx", "space_for", "cache_path", "mode",
           "backend_of", "stats", "main", "SCHEMA_VERSION",
           "PLAYOFF_MARGIN", "PRECISION_MARGIN", "FUSION_MARGIN"]
