"""One run of one cell: set-up, the measured window, the readers, the
check, and the result line's fields."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time

import torch

from harness import check as check_lib
from harness import drive
from harness import trace as trace_lib


@dataclasses.dataclass
class Window:
    """What the readers in ``metrics/`` read."""
    cell: object
    calls: list
    window_s: float
    setup_s: float
    peak_mem_bytes: int
    harness_bytes: int      # of the peak: the pool and the kept outputs
    launches: dict          # kernel wrapper counter -> launches in window
    spans: list             # the program's spans in the window (traced)
    trace: dict | None      # the profiler's reduction (traced)

    memo: dict = dataclasses.field(default_factory=dict)

    def counts(self, call) -> dict:
        """The pipeline's counts (``counts/``) of one call's shapes."""
        key = (call.rows, call.n_in)
        if key not in self.memo:
            self.memo[key] = self.cell.pipeline.counts(
                self.cell.config, call.rows, call.n_in)
        return self.memo[key]


def launch_counts() -> dict:
    """Every ``*LAUNCHES`` counter of the port's kernel wrappers."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith("repro_torch.kernels.") or mod is None:
            continue
        for attr, v in vars(mod).items():
            if attr.endswith("LAUNCHES") and isinstance(v, int):
                out[f"{name.rsplit('.', 1)[1]}.{attr}"] = v
    return out


@contextlib.contextmanager
def gc_pauses():
    """The seconds of each garbage collection while the block runs."""
    pauses, t = [], [0.0]

    def note(phase, info):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            pauses.append(time.perf_counter() - t[0])
    gc.callbacks.append(note)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(note)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run(cell, seed: int, seconds: float, traced: bool, dev: torch.device,
        t_start: float, entry_hook=None, controls=None
        ) -> tuple[dict, Window]:
    """Set up from ``t_start`` (the process's start), measure ``seconds``,
    read the metrics, check the kept outputs; returns the result line's
    fields and the window.  ``entry_hook(entry)`` may replace parts of the
    system under test (the fault tests break it there); ``controls``
    ({name: judge}, see ``check.gaps``) are judged on the same kept
    calls, their widest gaps under the result's ``"controls"``."""
    from repro_torch import obs
    torch.backends.cuda.matmul.allow_tf32 = False   # the reference's f64/f32
    cfg, traffic = cell.config, cell.traffic
    d = drive.Device(dev)
    marks = [("imports", time.perf_counter())]
    pool = drive.make_pool(cfg, traffic, seed, dev)
    d.sync()
    marks.append(("card and pool", time.perf_counter()))
    entry = drive.Entry(cell, pool, dev)
    if entry_hook is not None:
        entry_hook(entry)
    k0 = drive.warm(entry, d, int(traffic["warmup_calls"]))
    marks.append(("plans and warm-up", time.perf_counter()))
    # what set-up made lives to the end: a full collection in the window
    # would walk it, a pause the program's callers would not see
    gc.collect()
    gc.freeze()
    print("setup s: " + ", ".join(
        f"{name} {t - prev:.3f}" for (name, t), prev
        in zip(marks, [t_start] + [t for _, t in marks])), file=sys.stderr)
    keeper = drive.Keeper(seed, int(traffic["check_runs"]),
                          int(traffic["check_run_len"]))
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    prof = trace_lib.Profile(cuda) if traced else None
    if prof is not None:
        prof.begin()
    # the window's own loop, outputs kept as the check keeps them: the
    # memory allocator's cache grows here, where a new segment inside
    # the window stalls the host for tens of milliseconds
    loop = {"closed": drive.closed, "open": drive.open_loop}[traffic["mode"]]
    pre, _ = loop(entry, d, traffic, float(traffic.get("preroll_s", 0)), k0,
                  drive.Keeper(seed, keeper.runs, keeper.run_len))
    k0 += len(pre)
    del pre
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    n_events = len(obs.events())
    if prof is not None:
        obs.enable()
    launches0 = launch_counts()
    mark = prof.span if prof is not None else drive.no_mark
    t_window = time.perf_counter()
    with gc_pauses() as pauses, mark(trace_lib.WINDOW):
        calls, window_s = loop(entry, d, traffic, seconds, k0, keeper, mark)
    print(f"gc in the window: {len(pauses)} collections, longest "
          f"{max(pauses, default=0) * 1e3:.3f} ms, all "
          f"{sum(pauses) * 1e3:.3f} ms", file=sys.stderr)
    slow = sorted(calls, key=lambda c: c.host_s, reverse=True)[:8]
    print("longest calls into the program (ms @ s issued): " + " ".join(
        f"{c.host_s * 1e3:.2f}@{c.issued:.3f}" for c in slow),
        file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches1 = launch_counts()
    spans = []
    if prof is not None:
        obs.disable()
        spans = obs.events()[n_events:]
    reduced = prof.reduce() if prof is not None else None
    w = Window(cell, calls, window_s, t_window - t_start, peak,
               pool.numel() * pool.element_size() + keeper.most_bytes,
               {k: v - launches0.get(k, 0) for k, v in launches1.items()},
               spans, reduced)
    if traffic["mode"] == "open":
        late = sorted(((c.issued - c.due, c.due) for c in calls),
                      reverse=True)
        q = lambda f: late[min(len(late) - 1, int((1 - f) * len(late)))][0]
        print(f"generator lateness ms: p50 {q(0.5) * 1e3:.4f} p99 "
              f"{q(0.99) * 1e3:.4f} max {late[0][0] * 1e3:.4f} over "
              f"{len(calls)} calls; latest (ms late @ s due): "
              + " ".join(f"{a * 1e3:.2f}@{b:.3f}" for a, b in late[:8]),
              file=sys.stderr)

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = cell.readers[m["name"]].read(w)
        if v is None:
            print(f"metric {m['name']}: nothing to read, left out",
                  file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check, once the window has closed and the program's state is
    # freed: the kept outputs and the pool stay
    off = check_lib.off_config(entry, cfg)
    missing = check_lib.steps_missing(entry)
    entry.close()
    gaps = check_lib.gaps(keeper.kept(), entry, lambda x, call, out: out)
    limits = cfg["limits"]
    checks = {
        "power_gap": {"value": max(gaps, default=check_lib.FAIL),
                      "limit": limits["power_gap"]},
        "steps_missing": {"value": missing, "limit": 0},
        "off_config": {"value": off, "limit": 0},
    }
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": _device_name(dev), "count": cell.chips,
              "memory_peak_bytes": max(setup_peak, peak)}
    if reduced is not None:
        device["busy_s"] = reduced["busy_s"]
        device["window_s"] = reduced["window_s"]
    result = {"correct": check_lib.verdict(checks),
              "attempted": len(calls),
              "failed": sum(g > limits["power_gap"] for g in gaps),
              "metrics": metrics, "device": device}
    if reduced is not None:
        result["breakdown"] = reduced["breakdown"]
    if controls:
        result["controls"] = {
            name: max(check_lib.gaps(keeper.kept(), entry, judge),
                      default=check_lib.FAIL)
            for name, judge in controls.items()}
    result["checks"] = checks
    return result, w
