"""The one general traffic generator, driven by a traffic file's numbers.

Inputs: a pool of ``pool_chunks`` arrays of (signals, ``chunk_len``)
float32 samples, made on the device from the seed in one call.  The
stream a cell sees is the pool's chunks in turn, over and over.

Entries (``"entry"``): ``"stream"`` pushes each chunk into one
``ChunkedRunner``; ``"offline"`` calls one compiled ``Plan`` on each
chunk as a whole array.

Modes (``"mode"``):

* ``"closed"``: ``in_flight`` calls dispatched ahead, each retired by
  a CUDA event; calls are issued until ``seconds`` have passed, then the
  window ends with a synchronize.
* ``"open"``: a digitizer's schedule, call j due at ``j / rate``
  seconds, for ``seconds``, where ``rate`` is ``real_time_share`` of the
  configuration's own sample rate (``sample_rate_hz / chunk_len`` chunks
  a second: a share of 1 is the instrument's real time); a spinning feeder issues a call at its due
  time or, when the host runs late, as soon as it can.  Its latency
  runs from its due time to the moment its output's event completed.  At most
  ``max_in_flight`` calls are outstanding; the schedule never waits on
  the device otherwise.

Before the window, as set-up, the same loop runs for ``preroll_s``
seconds (none where the file gives none) with outputs kept as the check keeps them, so that the window
opens with the card, the host and the memory allocator's cache at the
cell's load and not from idle.

Answers kept for the check: the window's calls are split into runs of
``check_run_len`` consecutive calls, and ``check_runs`` of them are drawn
from the seed by reservoir sampling, so that every run of the window is
as likely to be judged and the kept outputs are as many in every run.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import random
import time

import torch

CLOCK = time.perf_counter


def no_mark(name):
    """``mark`` outside a traced run: names nothing."""
    return contextlib.nullcontext()


@dataclasses.dataclass
class Call:
    index: int          # stream position: the k-th chunk since set-up began
    step0: int          # index of the call's first output step in the stream
    steps: int          # output steps it emitted
    rows: int
    n_in: int           # samples a row of the window the op read
    samples: int        # new input samples it consumed (chunk size)
    issued: float       # s since the window opened
    host_s: float = 0.0          # s the host spent in the program's call
    due: float | None = None     # open loop: s since the window opened
    ready: float | None = None   # open loop: output ready, same clock


class Device:
    """Events and synchronization on the card; on the CPU (the tests)
    every call has finished when it returns."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.cuda = dev.type == "cuda"

    def event(self):
        if not self.cuda:
            return CLOCK()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wait(self, e) -> None:
        if self.cuda:
            e.synchronize()

    def done(self, e) -> bool:
        return not self.cuda or e.query()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def since(self, ref, e) -> float:
        """Seconds from event ``ref`` to event ``e``."""
        if not self.cuda:
            return e - ref
        return ref.elapsed_time(e) / 1e3


def make_pool(cfg: dict, traffic: dict, seed: int,
              dev: torch.device) -> torch.Tensor:
    """(pool_chunks, signals, chunk_len) float32 white noise of unit
    variance, drawn on the device from ``seed`` in one call."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (traffic["pool_chunks"], cfg["signals"], traffic["chunk_len"])
    return torch.randn(shape, generator=g, device=dev, dtype=torch.float32)


def chunk_rate(cfg: dict, traffic: dict) -> float:
    """Chunks a second of an open loop: ``real_time_share`` of the rate
    at which the configuration's instrument makes a chunk's samples."""
    return (float(traffic["real_time_share"]) * float(cfg["sample_rate_hz"])
            / int(traffic["chunk_len"]))


def stream_slice(pool: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Samples [a, b) of every row of the endless stream the pool's
    chunks make in turn."""
    k, _, n = pool.shape
    parts = []
    while a < b:
        c, off = divmod(a, n)
        take = min(b - a, n - off)
        parts.append(pool[c % k, :, off:off + take])
        a += take
    return torch.cat(parts, dim=-1)


class Entry:
    """The system under test as the window drives it: ``submit(k)`` runs
    the k-th chunk through the program and returns its output."""

    def __init__(self, cell, pool: torch.Tensor, dev: torch.device):
        from repro_torch import graph as graph_lib
        cfg = cell.config
        self.kind = cell.traffic["entry"]
        self.pipeline, self.config = cell.pipeline, cfg
        self.pool = pool
        self.block, self.receptive = cell.pipeline.reach(cfg)
        self.graph = cell.pipeline.graph(cfg)
        self.options = dict(lowering=cfg["lowering"],
                            precision=cfg["precision"], device=str(dev))
        self.steps_out = 0
        self.submitted = 0
        self.shapes: set[tuple[int, int]] = set()
        if self.kind == "stream":
            self.runner = graph_lib.ChunkedRunner(self.graph, **self.options)
        elif self.kind == "offline":
            self.plan = graph_lib.compile(
                self.graph, {"x": tuple(pool.shape[1:])}, **self.options)
        else:
            raise ValueError(f"unknown entry {self.kind!r}")

    def submit(self, k: int) -> tuple[torch.Tensor, Call]:
        x = self.pool[k % self.pool.shape[0]]
        rows, n = x.shape
        if self.kind == "stream":
            out = self.runner.push(x)
            step0 = self.steps_out
        else:
            out = self.plan(x)
            step0 = 0
        steps = out.shape[-2]
        self.steps_out += steps
        self.submitted += 1
        n_in = (steps - 1) * self.block + self.receptive
        self.shapes.add((rows, n_in))
        return out, Call(k, step0, steps, rows, n_in, rows * n, 0.0)

    def window_input(self, call: Call) -> torch.Tensor:
        """The input the call's output steps were computed from."""
        if self.kind == "offline":
            return self.pool[call.index % self.pool.shape[0]]
        a = call.step0 * self.block
        return stream_slice(self.pool, a, a + call.n_in)

    def plans(self) -> list:
        """The plans the window ran, as compile's cache holds them."""
        from repro_torch import graph as graph_lib
        return [graph_lib.compile(self.graph, {"x": s}, **self.options)
                for s in sorted(self.shapes)]

    def close(self) -> None:
        from repro_torch import graph as graph_lib
        self.runner = self.plan = None
        graph_lib.clear_cache()


class Keeper:
    """Reservoir sampling of runs of ``run_len`` consecutive calls."""

    def __init__(self, seed: int, runs: int, run_len: int):
        self.rng = random.Random(seed)
        self.runs, self.run_len = runs, run_len
        self.slots: list[list] = []
        self.seen = 0
        self._open: list | None = None
        self.bytes = self.most_bytes = 0    # of the outputs kept

    @staticmethod
    def _size(run: list) -> int:
        return sum(out.numel() * out.element_size() for _, out in run)

    def offer(self, i: int, call: Call, out) -> None:
        """Call number ``i`` of the window, with its output."""
        if i % self.run_len == 0:
            j, self.seen = self.seen, self.seen + 1
            self._open = None
            if j < self.runs:
                self._open = []
                self.slots.append(self._open)
            else:
                r = self.rng.randrange(j + 1)
                if r < self.runs:
                    self.bytes -= self._size(self.slots[r])
                    self._open = self.slots[r] = []
        if self._open is not None:
            self._open.append((call, out))
            self.bytes += out.numel() * out.element_size()
            self.most_bytes = max(self.most_bytes, self.bytes)

    def kept(self) -> list[list]:
        return [s for s in self.slots if s]


def warm(entry: Entry, dev: Device, calls: int) -> int:
    """Run ``calls`` calls through the entry, all outstanding at once:
    every shape the window will use, the plans compiled and their consts
    made, and the memory allocator's cache grown to hold that many
    calls' outputs (an open loop's ``max_in_flight``), so that a backlog
    in the window finds its memory made; returns the next stream
    position."""
    outs = [entry.submit(k)[0] for k in range(calls)]
    dev.sync()
    del outs
    return calls


def closed(entry: Entry, dev: Device, traffic: dict, seconds: float,
           k0: int, keeper: Keeper, mark=no_mark
           ) -> tuple[list[Call], float]:
    """Calls issued back to back, ``in_flight`` ahead, until ``seconds``
    have passed; the window ends with a synchronize.  ``mark(name)``
    names the host's calls into the program and its waits in a traced
    run."""
    depth = int(traffic["in_flight"])
    inflight: collections.deque = collections.deque()
    calls: list[Call] = []
    t0 = CLOCK()
    t_end = t0 + seconds
    k = k0
    while CLOCK() < t_end:
        if len(inflight) >= depth:
            with mark("bench.wait_oldest"):
                dev.wait(inflight.popleft()[1])
        t = CLOCK()
        with mark("bench.call"):
            out, call = entry.submit(k)
        call.issued, call.host_s = t - t0, CLOCK() - t
        inflight.append((out, dev.event()))
        keeper.offer(len(calls), call, out)
        calls.append(call)
        k += 1
    dev.sync()
    return calls, CLOCK() - t0


def _wait_until(t: float, retire) -> None:
    """Spin until ``t``, retiring finished calls: a digitizer's feeder
    polls, and a sleeping thread wakes up late by the scheduler's whim."""
    while CLOCK() < t:
        retire()


def open_loop(entry: Entry, dev: Device, traffic: dict, seconds: float,
              k0: int, keeper: Keeper, mark=no_mark
              ) -> tuple[list[Call], float]:
    """Call j due at ``j / rate`` for the window's ``seconds``; each
    call's ready time from its CUDA event."""
    rate = chunk_rate(entry.config, traffic)
    cap = int(traffic["max_in_flight"])
    n_due = int(seconds * rate)
    inflight: collections.deque = collections.deque()
    calls, events = [], []

    def retire():
        while inflight and dev.done(inflight[0][1]):
            inflight.popleft()

    dev.sync()
    ref = dev.event()
    t0 = CLOCK()
    for j in range(n_due):
        due = j / rate
        with mark("bench.wait_due"):
            _wait_until(t0 + due, retire)
        if len(inflight) >= cap:
            with mark("bench.wait_oldest"):
                dev.wait(inflight.popleft()[1])
        t = CLOCK()
        with mark("bench.call"):
            out, call = entry.submit(k0 + j)
        call.due, call.issued, call.host_s = due, t - t0, CLOCK() - t
        e = dev.event()
        inflight.append((out, e))
        events.append(e)
        keeper.offer(j, call, out)
        calls.append(call)
        retire()
    dev.sync()
    window = CLOCK() - t0
    for call, e in zip(calls, events):
        call.ready = dev.since(ref, e)
    return calls, window
