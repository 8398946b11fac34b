"""The ``pfb_power`` pipeline as the benchmark drives it: the graph built
through the port's public ``Graph`` API (``input``, ``const``,
``apply("pfb")``, ``apply("abs2")``, ``output``) from the taps the
reference makes, and the reference, control and counts of one call.

Every pipeline module gives the same five names; a configuration names
its pipeline with ``"pipeline"``."""
from __future__ import annotations

import numpy as np
import torch

from counts import pfb_power as counts_lib
from reference import pfb_power as ref


def _taps(cfg: dict) -> np.ndarray:
    return ref.taps(cfg["n_branches"], cfg["n_taps"], cfg["window"])


def graph(cfg: dict):
    """The program's graph: x -> pfb(x, taps) -> abs2."""
    from repro_torch.graph import Graph
    g = Graph(f"pfb_power_p{cfg['n_branches']}m{cfg['n_taps']}")
    x = g.input("x")
    t = g.const(_taps(cfg), "taps")
    z = g.apply("pfb", x, t)
    g.output(g.apply("abs2", z))
    return g


def reach(cfg: dict) -> tuple[int, int]:
    """(block, receptive) of one output step, in input samples."""
    return ref.stream_reach(cfg["n_branches"], cfg["n_taps"])


def reference(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """float64 power of the input window x (rows, n)."""
    return ref.power(x, torch.from_numpy(_taps(cfg)))


def control(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The reference one precision step down (its DFT in one TF32 pass)."""
    return ref.power_tf32(x, torch.from_numpy(_taps(cfg)))


def counts(cfg: dict, rows: int, n: int) -> dict:
    return counts_lib.call(cfg, rows, n)
