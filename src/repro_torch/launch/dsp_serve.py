"""DSP pipeline serving launcher: batched requests through cached plans,
on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.dsp_serve \\
        --pipeline spectrogram --requests 64 --batch 8 --signal-len 4096

Spins up a :class:`repro_torch.graph.service.PipelineService` for one
built-in pipeline, drives it with synthetic requests from a background
batcher thread, validates a sample of responses against the pipeline's
numpy oracle, and reports throughput and batching efficiency.
``--lowering kernel`` runs the hand-written CUDA kernels; ``--lowering
auto`` engages the measuring autotuner (winners persist to the on-disk
tuning cache, so a second launch skips the measurements).

``--batching continuous`` swaps the fixed packer for the continuous
batcher (a ladder of pre-compiled bucket plans, 1/2/4/.../--batch);
``--prewarm`` then tunes every bucket shape, whatever the ambient
``TINA_AUTOTUNE`` mode, so a ``TINA_AUTOTUNE=cached`` launch still
serves tuned kernels.

Robustness: ``--queue-limit N --on-full shed|block|raise``,
``--deadline-ms``, ``--max-retries`` and ``--validate strict``.  The
drive loop is outcome-tolerant: every future resolves with a result or
a typed exception, and a robustness summary is printed when anything
non-nominal happened.  ``--poison K`` corrupts K requests with NaNs and
**asserts** they all fail typed while no healthy request is harmed (arm
``TINA_FAULTS="device_run:nan"`` or ``--validate strict``).

Multi-tenant serving: ``--tenants pfb_power,fir_decimate`` adds extra
pipelines as named tenants of the same service; requests round-robin
across every tenant.  ``--priority mix`` alternates the rt/batch
classes.  ``--overlap on`` forces the double-buffered scheduler in fixed
mode; continuous batching overlaps by default.  ``--async`` drives the
load through ``await service.submit_async(...)`` under ``async with``.

Observability: ``--trace out.json`` writes a Chrome trace of the whole
run; ``--metrics-interval S`` prints a JSON metrics snapshot to stderr
every S seconds.  ``--torch-profiler DIR`` brackets the serving window
with ``torch.profiler`` (CPU, and CUDA on the card), writes its trace to
``DIR/torch_trace.json`` and prints the five host ops with the most self
time per batch.  The profiler records the ops of the thread that started
it, so under this flag the launcher drains the queue with ``flush()`` on
its own thread instead of starting the batcher thread.

``main`` returns a summary dict (requests served, seconds, the service's
stats, the profile) for callers that run it in process.

Sharding: ``--mesh N`` shards each batch across N devices (a
:class:`~repro_torch.launch.mesh.BatchMesh`; the continuous ladder then
starts at N).  ``--devices N`` limits the devices the mesh may take: N
visible cards (more than the card count raises), or under ``--device
cpu`` N logical CPU shards, the counterpart of the reference's forced
host device count (one without it).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", default="spectrogram")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--signal-len", type=int, default=4096)
    ap.add_argument("--lowering", default="native",
                    choices=["native", "conv", "kernel", "auto"],
                    help="kernel: the hand-written CUDA kernels (the "
                         "reference's pallas); auto: the measuring "
                         "autotuner picks per node")
    ap.add_argument("--precision", default="f32",
                    choices=["f32", "bf16", "int8", "auto"],
                    help="execution tier for every bucket plan (responses "
                         "are oracle-checked by SQNR instead of allclose "
                         "below f32)")
    ap.add_argument("--device", default=None,
                    help="where the plans run (default cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--tune-blocks", action="store_true",
                    help="autotune kernel block sizes for the chosen "
                         "lowering (lowering=auto already tunes them "
                         "jointly)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard each batch across N devices (0 = "
                         "single-device plan)")
    ap.add_argument("--devices", type=int, default=0, metavar="N",
                    help="devices the mesh may take: N visible cards "
                         "(raises above the card count), or N logical "
                         "shards under --device cpu (default: every card; "
                         "one CPU shard)")
    ap.add_argument("--batching", default="fixed",
                    choices=["fixed", "continuous"],
                    help="fixed: pad every batch to --batch behind a "
                         "--max-wait-ms fill deadline; continuous: "
                         "dispatch the largest queued batch the moment "
                         "the device is idle through a ladder of "
                         "pre-compiled bucket plans")
    ap.add_argument("--overlap", default="auto",
                    choices=["auto", "on", "off"],
                    help="double-buffered scheduler: pack batch N+1 on "
                         "the host while the card runs batch N (auto = on "
                         "for --batching continuous, off for fixed)")
    ap.add_argument("--tenants", metavar="P1,P2", default=None,
                    help="comma-separated extra pipelines to serve as "
                         "named tenants of the same service; requests "
                         "round-robin across all tenants")
    ap.add_argument("--priority", default="batch",
                    choices=["batch", "rt", "mix"],
                    help="priority class for submitted requests; mix "
                         "alternates rt/batch")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="drive the load through the asyncio front "
                         "door: async with PipelineService(...) + "
                         "await submit_async(...)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="fixed-mode fill deadline per request (no effect "
                         "under --batching continuous)")
    ap.add_argument("--check", type=int, default=4,
                    help="responses to validate against the numpy oracle")
    ap.add_argument("--queue-limit", type=int, default=0, metavar="N",
                    help="bound the admission queue at N requests "
                         "(0 = unbounded); see --on-full")
    ap.add_argument("--on-full", default="block",
                    choices=["block", "shed", "raise"],
                    help="policy when the bounded queue is full")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request scheduling deadline (0 = none)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="transient batch-failure retries before the "
                         "batch is bisected to isolate poison rows")
    ap.add_argument("--validate", default="off",
                    choices=["off", "strict"],
                    help="strict: reject non-finite payloads at submit")
    ap.add_argument("--poison", type=int, default=0, metavar="K",
                    help="corrupt K requests with NaNs and assert they "
                         "all fail with typed exceptions while healthy "
                         "requests are unaffected (arm "
                         "TINA_FAULTS=device_run:nan or --validate "
                         "strict)")
    ap.add_argument("--prewarm", action="store_true",
                    help="run the autotuner for the serving shape(s) "
                         "before accepting traffic, persisting winners "
                         "to the tuning cache")
    ap.add_argument("--tune-repeats", type=int, default=2,
                    help="per-candidate repeats inside the pre-warm")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="collect telemetry spans and write a Chrome "
                         "trace-event JSON")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    metavar="SEC",
                    help="print a JSON metrics snapshot to stderr every "
                         "SEC seconds while serving (0 = off)")
    ap.add_argument("--torch-profiler", metavar="DIR", default=None,
                    help="bracket the serving window with torch.profiler "
                         "(CPU, and CUDA on the card), write "
                         "DIR/torch_trace.json and print the top host "
                         "ops per batch; drains with flush() on the "
                         "launcher's thread")
    return ap


def _result_or_exception(fut, timeout: float = 600.0):
    try:
        return fut.result(timeout=timeout)
    except Exception as e:   # noqa: BLE001 — typed failures ARE outcomes
        return e


def _metrics_snapshot(svc) -> dict:
    """The service's stats snapshot plus the process-wide plan-cache and
    autotuner counts."""
    from repro_torch.graph import autotune, plan as plan_lib
    return {"time": time.time(), "service": svc.stats(),
            "plan_cache": plan_lib.cache_stats(),
            "autotune": autotune.stats()}


def _start_metrics_thread(svc, interval: float):
    """Emit one JSON metrics line to stderr every ``interval`` seconds
    until the returned event is set."""
    stop = threading.Event()

    def loop():
        while not stop.wait(interval):
            print(json.dumps(_metrics_snapshot(svc)), file=sys.stderr,
                  flush=True)

    threading.Thread(target=loop, daemon=True).start()
    return stop


def prewarm(graph_obj, batch: int, signal_len: int, *, lowering: str,
            precision: str = "f32", device=None, mesh=None,
            repeats: int = 2) -> dict:
    """Measure-and-persist autotune entries for one serving shape.

    Temporarily forces ``TINA_AUTOTUNE=on`` (the point is to measure
    ahead of traffic even when serving runs ``cached``), compiles the
    serving-shaped plan with the tuner engaged on ``device``, and
    returns the tuner's stats delta.  ``lowering="auto"`` tunes lowering
    and tiling jointly; a fixed lowering tunes its tiling only.  Under
    ``mesh=`` the tuner measures the per-shard shape."""
    from repro_torch.graph import autotune, plan as plan_lib

    prev = os.environ.get("TINA_AUTOTUNE")
    os.environ["TINA_AUTOTUNE"] = "on"
    try:
        before = autotune.stats()
        opts = plan_lib.CompileOptions(
            lowering=lowering,
            block_configs=None if lowering == "auto" else "auto",
            precision=precision, device=device, mesh=mesh,
            autotune_kwargs={"repeats": repeats})
        plan_lib.compile(graph_obj,
                         {graph_obj.inputs[0]: (batch, signal_len)},
                         options=opts)
        after = autotune.stats()
        return {k: after[k] - before[k] for k in after}
    finally:
        if prev is None:
            os.environ.pop("TINA_AUTOTUNE", None)
        else:
            os.environ["TINA_AUTOTUNE"] = prev


def _top_host_ops(prof, batches: int, k: int = 5) -> list[dict]:
    """The ``k`` ops with the most self time on the host, per batch."""
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:k]
    per = max(1, batches)
    return [{"op": e.key, "self_host_us_per_batch":
             e.self_cpu_time_total / per, "calls_per_batch": e.count / per}
            for e in rows]


def _device_us(prof) -> float:
    """Self time the profiler saw on the card, all ops (0 when it saw
    none, as on the CPU)."""
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)) or 0.0
    return total


def _mesh(args):
    """The BatchMesh ``--mesh``/``--devices`` ask for (None: unsharded)."""
    import torch

    from repro_torch.launch.mesh import make_batch_mesh
    on_cpu = torch.device(args.device or "cuda").type == "cpu"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if args.devices and not on_cpu and args.devices > cards:
        raise ValueError(f"--devices {args.devices}: {cards} card(s) "
                         "visible; a card count cannot be faked (--device "
                         "cpu gives logical shards)")
    if not args.mesh:
        return None
    available = args.devices or (1 if on_cpu else cards)
    if not 1 <= args.mesh <= available:
        raise ValueError(f"make_batch_mesh: {args.mesh} devices requested, "
                         f"{available} available")
    return make_batch_mesh(args.mesh, device=args.device)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    mesh = _mesh(args)

    from repro_torch import obs
    from repro_torch.core.registry import PIPELINES, pipelines
    from repro_torch.graph import plan as plan_lib
    from repro_torch.graph.plan import CompileOptions
    from repro_torch.graph.service import PipelineService

    if args.trace:
        obs.enable()                 # asking for a trace IS the opt-in
    pipelines()
    if args.pipeline not in PIPELINES:
        raise SystemExit(f"unknown pipeline {args.pipeline!r}; "
                         f"choices: {sorted(PIPELINES)}")
    spec = PIPELINES[args.pipeline]
    g = spec.build()
    n = spec.valid_len(args.signal_len)   # e.g. PFB branch divisibility
    if n != args.signal_len:
        print(f"[dsp_serve] signal-len {args.signal_len} -> {n} "
              f"({args.pipeline} length constraint)")
    rng = np.random.default_rng(0)

    if args.prewarm:
        from repro_torch.graph import autotune
        from repro_torch.graph.service import bucket_ladder
        t0 = time.perf_counter()
        # a continuous service runs every bucket shape of its ladder:
        # tune them all
        sizes = (bucket_ladder(args.batch, args.mesh or 1)
                 if args.batching == "continuous" else (args.batch,))
        delta: dict = {}
        for b in sizes:
            d = prewarm(g, b, n, lowering=args.lowering,
                        precision=args.precision, device=args.device,
                        mesh=mesh, repeats=args.tune_repeats)
            delta = {k: delta.get(k, 0) + v for k, v in d.items()}
        print(f"[dsp_serve] prewarm: tuned {len(sizes)} serving shape(s) "
              f"{[(b, n) for b in sizes]} in "
              f"{time.perf_counter() - t0:.2f}s — "
              f"measured {delta['measured']} node(s), "
              f"{delta['cache_hits']} already cached "
              f"(cache: {autotune.cache_path()})")
        # the pre-warm measured block configs for this lowering; make the
        # service read them
        args.tune_blocks = args.tune_blocks or args.lowering != "auto"

    t0 = time.perf_counter()
    opts = CompileOptions(
        lowering=args.lowering,
        precision=args.precision,
        block_configs="auto" if args.tune_blocks else None,
        device=args.device, mesh=mesh)
    overlap = (None if args.overlap == "auto"
               else args.overlap == "on")
    svc = PipelineService(g, signal_len=n, batch_size=args.batch,
                          batching=args.batching,
                          options=opts,
                          overlap=overlap,
                          max_wait_ms=args.max_wait_ms,
                          queue_limit=args.queue_limit or None,
                          on_full=args.on_full,
                          deadline_ms=args.deadline_ms or None,
                          max_retries=args.max_retries,
                          validate=args.validate)
    tenant_specs = {"default": spec}
    tenant_lens = {"default": n}
    if args.tenants:
        for tn in [t.strip() for t in args.tenants.split(",") if t.strip()]:
            if tn not in PIPELINES:
                raise SystemExit(f"--tenants: unknown pipeline {tn!r}; "
                                 f"choices: {sorted(PIPELINES)}")
            if tn in tenant_specs:
                continue
            tspec = PIPELINES[tn]
            tlen = tspec.valid_len(args.signal_len)
            svc.add_tenant(tn, tspec.build(), tlen,
                           batch_size=args.batch)
            tenant_specs[tn] = tspec
            tenant_lens[tn] = tlen
    t_compile = time.perf_counter() - t0
    tuned = {k: v for k, v in svc.plan.configs.items() if v}
    sharded = ""
    if svc.plan.mesh is not None:
        m = svc.plan.mesh
        sharded = (f", mesh {m.shape} "
                   f"({args.batch // m.size} rows/device)")
    ladder = (f", buckets {list(svc.buckets)}"
              if args.batching == "continuous" else "")
    prec = ("" if args.precision == "f32"
            else f", precisions: {svc.plan.precisions}")
    nplans = sum(len(t.plans) for t in svc.tenants.values())
    multi = (f", {len(svc.tenants)} tenants" if len(svc.tenants) > 1
             else "")
    print(f"[dsp_serve] {args.pipeline}: {nplans} plan(s) compiled "
          f"in {t_compile:.2f}s on {svc.plan.device} (lowerings: "
          f"{svc.plan.lowerings}"
          + (f", block configs: {tuned}" if tuned else "")
          + sharded + prec + ladder + multi + ")")

    # round-robin the request load across every tenant; --priority mix
    # alternates rt/batch so both classes are exercised
    tenant_names = list(tenant_specs)
    reqs = []
    for i in range(args.requests):
        tn = tenant_names[i % len(tenant_names)]
        x = rng.standard_normal(tenant_lens[tn]).astype(np.float32)
        pr = ("rt" if args.priority == "rt"
              or (args.priority == "mix" and i % 2 == 0) else "batch")
        reqs.append((tn, pr, x))
    poison_idx: set = set()
    if args.poison:
        if args.poison > len(reqs):
            raise SystemExit(f"--poison {args.poison} > --requests "
                             f"{len(reqs)}")
        # spread the poison so it lands in different batches
        poison_idx = set(np.linspace(0, len(reqs) - 1,
                                     args.poison).astype(int).tolist())
        for i in poison_idx:
            x = reqs[i][2]
            x[x.shape[-1] // 3] = np.nan
    metrics_stop = (_start_metrics_thread(svc, args.metrics_interval)
                    if args.metrics_interval > 0 else None)
    prof = None
    if args.torch_profiler:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if svc.plan.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    plans_before = plan_lib.cache_stats()["misses"]
    t0 = time.perf_counter()
    try:
        if prof is not None:
            # the profiler sees this thread's ops only: drain here
            futs = []
            for tn, pr, x in reqs:
                try:
                    futs.append(svc.submit(x, priority=pr, tenant=tn))
                except Exception as e:  # noqa: BLE001 on_full="raise"
                    futs.append(e)
            svc.flush()
            svc.close()
            outs = [f if isinstance(f, Exception) else
                    _result_or_exception(f) for f in futs]
        elif args.use_async:
            import asyncio

            async def _drive():
                async with svc:
                    return await asyncio.gather(
                        *(svc.submit_async(x, priority=pr, tenant=tn)
                          for tn, pr, x in reqs),
                        return_exceptions=True)

            outs = list(asyncio.run(_drive()))
        else:
            with svc:
                futs = []
                for tn, pr, x in reqs:
                    try:
                        futs.append(svc.submit(x, priority=pr, tenant=tn))
                    except Exception as e:  # noqa: BLE001 on_full="raise"
                        futs.append(e)
                outs = [f if isinstance(f, Exception) else
                        _result_or_exception(f) for f in futs]
    finally:
        elapsed = time.perf_counter() - t0
        profile_out = None
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(args.torch_profiler, exist_ok=True)
            path = os.path.join(args.torch_profiler, "torch_trace.json")
            prof.export_chrome_trace(path)
            batches = svc.stats()["batches"]
            profile_out = {"trace": path, "batches": batches,
                           "device_self_us": _device_us(prof),
                           "top_host_ops": _top_host_ops(prof, batches)}
            print(f"[dsp_serve] torch profiler trace in {path}; top host "
                  "ops per batch (self us): " + ", ".join(
                      f"{r['op']} {r['self_host_us_per_batch']:.1f}"
                      for r in profile_out["top_host_ops"]))
        if metrics_stop is not None:
            metrics_stop.set()
            print(json.dumps(_metrics_snapshot(svc)), file=sys.stderr,
                  flush=True)
    compiled_serving = plan_lib.cache_stats()["misses"] - plans_before

    checked = 0
    min_sqnr = float("inf")
    for i, ((tn, _pr, x), o) in enumerate(zip(reqs, outs)):
        if isinstance(o, Exception) or i in poison_idx:
            continue                 # oracle-check served requests only
        tspec = tenant_specs[tn]
        if args.precision == "f32":
            np.testing.assert_allclose(o, tspec.oracle(x), rtol=2e-3,
                                       atol=2e-3)
        else:
            # reduced-precision responses are judged as their budgets
            # are: SQNR against the oracle, floored well below any budget
            from repro_torch.core.opdefs import sqnr_db
            q = sqnr_db(tspec.oracle(x), np.asarray(o))
            min_sqnr = min(min_sqnr, q)
            assert q > 20.0, (
                f"response {i}: SQNR {q:.1f} dB vs the numpy oracle at "
                f"precision={args.precision} — below the 20 dB sanity "
                "floor")
        checked += 1
        if checked >= args.check:
            break

    s = svc.stats()                  # one consistent locked snapshot
    served = sum(1 for o in outs if not isinstance(o, Exception))
    buckets = (f", buckets {s['bucket_batches']}"
               if "bucket_batches" in s else "")
    print(f"[dsp_serve] {served}/{len(outs)} requests served in "
          f"{elapsed:.3f}s ({served / elapsed:.1f} req/s), "
          f"{s['batches']} batches, "
          f"fill {s['fill_ratio']:.0%}{buckets}, plans compiled while "
          f"serving {compiled_serving} (0 == every batch was a cache hit)")
    if len(svc.tenants) > 1:
        print("[dsp_serve] tenants: " + ", ".join(
            f"{tn} {c['requests']} req / {c['batches']} batch(es)"
            for tn, c in s["tenants"].items()))
    if args.priority != "batch":
        print(f"[dsp_serve] priorities: {s['priorities']}")
    from collections import Counter
    from repro_torch.obs import faults
    failures = Counter(type(o).__name__ for o in outs
                       if isinstance(o, Exception))
    rob = {k: s[k] for k in ("shed", "expired", "retries", "quarantined",
                             "degraded", "invalid")}
    if any(rob.values()) or failures or faults.active():
        print(f"[dsp_serve] robustness: {rob}, failure types "
              f"{dict(failures)}, injected {faults.stats()}, runtime "
              f"downgrades {svc.downgrades}")
    if args.poison:
        leaked = [i for i in sorted(poison_idx)
                  if not isinstance(outs[i], Exception)]
        if leaked:
            raise SystemExit(
                f"[dsp_serve] --poison: corrupted request(s) {leaked} "
                "received results instead of typed failures — poison "
                "isolation is broken (is TINA_FAULTS=device_run:nan or "
                "--validate strict armed?)")
        harmed = sum(1 for i, o in enumerate(outs)
                     if i not in poison_idx and isinstance(o, Exception))
        print(f"[dsp_serve] poison isolation: {len(poison_idx)}/"
              f"{len(poison_idx)} corrupted request(s) failed typed "
              f"({sorted({type(outs[i]).__name__ for i in poison_idx})}), "
              f"{s['quarantined']} quarantined, {harmed} healthy "
              "request(s) caught in the blast radius")
    lat = s["latency_ms"]
    if lat["total"]["count"]:
        print("[dsp_serve] latency p50/p99 ms — "
              + ", ".join(f"{k} {lat[k]['p50']:.2f}/{lat[k]['p99']:.2f}"
                          for k in ("total", "queued", "pad", "device")))
    sq = (f" (min SQNR {min_sqnr:.1f} dB @ {args.precision})"
          if np.isfinite(min_sqnr) else "")
    print(f"[dsp_serve] {checked} response(s) verified against the "
          f"numpy oracle{sq}")
    if args.trace:
        n_events = obs.export_chrome_trace(args.trace)
        dropped = obs.REGISTRY.dropped_events
        print(f"[dsp_serve] wrote {n_events} trace events to {args.trace}"
              + (f" ({dropped} dropped: buffer full)" if dropped else "")
              + " — open in chrome://tracing or https://ui.perfetto.dev")
    return {"served": served, "requests": len(outs), "seconds": elapsed,
            "checked": checked, "compiled_while_serving": compiled_serving,
            "stats": s, "downgrades": {tn: dict(t.downgrades)
                                       for tn, t in svc.tenants.items()},
            "profile": profile_out}


if __name__ == "__main__":
    main()
