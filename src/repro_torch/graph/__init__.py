"""TINA pipeline-graph subsystem in torch: op graphs compiled into
cached plans that run on the card.

  graph.py      declarative graph IR (a copy of the reference's, so
                signatures hash the same) and ``load_graph``
  plan.py       planner: shape specialization, elementwise fusion,
                lowering and precision selection, memoized plans
  pipelines.py  built-in workloads (``spectrogram``, ``pfb_power``,
                ``fir_decimate``, ``stft_overlap_add``, ``correlate``,
                ``cascaded_channelizer``)

Quick use::

    from repro_torch import graph
    g = graph.build_pfb_power(n_branches=1024, n_taps=8)
    plan = graph.compile(g, {"x": (16, 2 ** 22)}, lowering="kernel")
    power = plan(x)                     # x: a float32 tensor on the card
    plan8 = graph.compile(g, {"x": (16, 2 ** 22)}, lowering="kernel",
                          precision="int8")   # the int8 kernels
"""
from repro_torch.core.opdefs import OPDEFS, OpDef
from repro_torch.graph import pipelines, plan
from repro_torch.graph.graph import Graph, Node, load_graph
from repro_torch.graph.pipelines import (BUILTINS,
                                         build_cascaded_channelizer,
                                         build_correlate, build_fir_decimate,
                                         build_pfb_power, build_spectrogram,
                                         build_stft_overlap_add,
                                         cascaded_channelizer_oracle,
                                         correlate_oracle,
                                         fir_decimate_oracle,
                                         pfb_power_oracle, spectrogram_oracle,
                                         stft_overlap_add_oracle)
from repro_torch.graph.plan import (CompileOptions, Plan, cache_stats,
                                    clear_cache, compile)

__all__ = [
    "Graph", "Node", "load_graph", "OpDef", "OPDEFS", "Plan",
    "CompileOptions", "compile", "cache_stats", "clear_cache", "BUILTINS",
    "build_pfb_power", "pfb_power_oracle", "build_spectrogram",
    "spectrogram_oracle", "build_fir_decimate", "fir_decimate_oracle",
    "build_stft_overlap_add", "stft_overlap_add_oracle", "build_correlate",
    "correlate_oracle", "build_cascaded_channelizer",
    "cascaded_channelizer_oracle", "pipelines", "plan",
]
