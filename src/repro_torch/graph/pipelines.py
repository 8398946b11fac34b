"""Built-in pipelines: whole signal-processing workloads as graphs,
registered in :data:`repro_torch.core.registry.PIPELINES`.

  * ``pfb_power``  polyphase filter bank -> |·|² (paper §5.2 + power)

Each entry carries a pure-numpy oracle over the same baked constants.
The reference's other five pipelines come with their slices.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import opdefs
from repro_torch.core import pfb as pfb_lib
from repro_torch.core.registry import TinaPipeline, register_pipeline
from repro_torch.graph.graph import Graph


def build_pfb_power(n_branches: int = 16, n_taps: int = 8) -> Graph:
    taps = pfb_lib.pfb_window(n_branches, n_taps).astype(np.float32)
    g = Graph(f"pfb_power_p{n_branches}m{n_taps}")
    x = g.input("x")
    t = g.const(taps, "taps")
    z = g.apply("pfb", x, t)
    out = g.apply("abs2", z)
    g.output(out)
    return g


def pfb_power_oracle(n_branches: int = 16, n_taps: int = 8):
    taps = pfb_lib.pfb_window(n_branches, n_taps).astype(np.float32)

    def oracle(x):
        x = np.asarray(x, np.float32)
        return np.abs(opdefs._np_pfb(x, taps)) ** 2   # canonical PFB oracle
    return oracle


register_pipeline(TinaPipeline(
    "pfb_power", "5.2",
    build=build_pfb_power, oracle=pfb_power_oracle(),
    lowerings=("native", "conv", "kernel"),
    make_args=lambda rng, n: (
        rng.standard_normal(16 * max(16, n // 16)).astype(np.float32),),
    round_len=lambda n: 16 * max(16, n // 16)))


BUILTINS = ("pfb_power",)

__all__ = ["BUILTINS", "build_pfb_power", "pfb_power_oracle"]
