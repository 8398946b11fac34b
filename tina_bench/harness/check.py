"""The comparison that decides ``correct``.

Each kept output of the window is judged against the plain reference,
worked out again from the input the benchmark made for that call (the
stream's samples the call's steps read, the carry included).  Numbers
compared, each with its limit from the configuration's ``"limits"``:

* ``power_gap``: over the kept calls and their rows, the widest gap
  max |out - ref| / max |ref| of a row (a NaN, a wrong shape or no call
  kept reads ``FAIL``);
* ``steps_missing``: output steps the stream should have emitted for the
  samples pushed and did not, or emitted twice (0: exact);
* ``off_config``: plan nodes whose lowering or precision is not the one
  the configuration states (0: exact).
"""
from __future__ import annotations

import math

import torch

FAIL = 1e9      # the gap of an output that cannot be compared


def row_gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows of max |out - ref| / max |ref| (rows: axis 0)."""
    if tuple(out.shape) != tuple(ref.shape):
        return FAIL
    d = (out.to(torch.float64) - ref).abs().flatten(1).amax(1)
    scale = ref.abs().flatten(1).amax(1)
    g = (d / scale).amax().item()
    return FAIL if not math.isfinite(g) else g


def gaps(kept, entry, judge) -> list[float]:
    """The row gap of ``judge``'s output against the reference for every
    kept call.  ``judge(x, call, out)`` returns what is judged: the
    program's output ``out``, or a control's on the call's input x."""
    pipeline, cfg = entry.pipeline, entry.config
    out_gaps = []
    for run in kept:
        for call, out in run:
            x = entry.window_input(call)
            ref = pipeline.reference(x, cfg)
            out_gaps.append(row_gap(judge(x, call, out), ref))
            del ref
    return out_gaps


def steps_missing(entry) -> int:
    """|steps emitted - steps the pushed samples complete| (streams)."""
    if entry.kind != "stream":
        return 0
    n = entry.submitted * entry.pool.shape[-1]
    due = (n - entry.receptive) // entry.block + 1
    return abs(entry.steps_out - due)


def off_config(entry, cfg: dict) -> int:
    """Plan nodes run at another lowering or precision than stated."""
    bad = 0
    for plan in entry.plans():
        for node, lw in plan.node_lowerings.items():
            bad += lw != cfg["lowering"]
            bad += plan.node_precisions.get(node, "f32") != cfg["precision"]
    return bad


def verdict(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
