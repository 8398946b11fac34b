"""The traced run's reduction: ``torch.profiler`` over the window, read
back as device intervals (kernels, copies, sets) and host events, all
clipped to the harness's ``bench.window`` range.

* ``busy_s``: the union of the device intervals, in seconds;
* ``kernels``: (name, start s, end s) of every device interval, for the
  per-layer readers;
* ``breakdown``: the ten device operations that took most time, and the
  ten longest idle gaps summed by what the host was in when each began
  (its innermost host event).
"""
from __future__ import annotations

import bisect
import collections
import re

WINDOW = "bench.window"
DEVICE_WORK = {"kernel", "gpu_memcpy", "gpu_memset"}   # kineto activities


def _device_work(e) -> bool:
    """A kernel, copy or set on the device, not a range the host marked
    (a ``record_function`` shows on the device's timeline too; the
    harness's own are named ``bench.*``)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_WORK
    marked = getattr(e, "is_user_annotation", None)
    return not e.name().startswith("bench.") and not (marked and marked())


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace noise and
    arguments: ``dft_tf32_kernel<false, false, 64>``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return name[:i]
    return name


class Profile:
    """Start with ``begin()`` before the window, wrap the window in
    ``span(WINDOW)``, then ``reduce()``."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def begin(self) -> None:
        self.prof.__enter__()

    def span(self, name: str):
        """A host range in the trace (``record_function``)."""
        from torch.profiler import record_function
        return record_function(name)

    def reduce(self) -> dict:
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        win = [e for e in events if e.name() == WINDOW
               and e.device_type().name == "CPU"]
        if len(win) != 1:
            raise RuntimeError(f"trace holds {len(win)} {WINDOW} ranges")
        w0, w1 = win[0].start_ns(), win[0].end_ns()
        dev, host = [], []
        for e in events:
            a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if b <= a and e.duration_ns() > 0:
                continue
            if e.device_type().name == "CUDA":
                if _device_work(e):
                    dev.append((e.name(), a, b))
            elif e.name() != WINDOW:
                host.append((e.name(), a, b))
        dev.sort(key=lambda t: t[1])
        busy, gaps, cur = 0, [], None
        for _, a, b in dev:
            if cur is None:
                cur = [a, b]
                gaps.append((w0, a))
            elif a > cur[1]:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a))
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
        if cur is not None:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], w1))
        else:
            gaps.append((w0, w1))
        by_op = collections.Counter()
        for n, a, b in dev:
            by_op[_short(n)] += (b - a) / 1e9
        return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
                "kernels": [(n, (a - w0) / 1e9, (b - w0) / 1e9)
                            for n, a, b in dev],
                "breakdown": {
                    "device_ops": [[n, s] for n, s in by_op.most_common(10)],
                    "idle_gaps": _gaps_by_host(gaps, host)}}


def _gaps_by_host(gaps, host) -> list:
    """The idle gaps' seconds summed by the innermost host event open at
    each gap's middle, the ten largest."""
    host.sort(key=lambda t: t[1])
    starts = [a for _, a, _ in host]
    by = collections.Counter()
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        label = "host: outside any traced op"
        # the open event that started last is the innermost
        for n, a, b in reversed(host[max(0, i - 256):i]):
            if a <= mid < b:
                label = n
                break
        by[label] += (g1 - g0) / 1e9
    return [[n, s] for n, s in by.most_common(10)]
