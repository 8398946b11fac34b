"""TINA pipeline-graph subsystem in torch: op graphs compiled into
cached plans that run on the card.

  graph.py      declarative graph IR (a copy of the reference's, so
                signatures hash the same) and ``load_graph``
  plan.py       planner: shape specialization, elementwise fusion,
                lowering and precision selection, memoized plans, batch
                sharding over a ``launch.mesh.BatchMesh``
  autotune.py   measuring lowering/config/precision/fusion autotuner,
                on-disk cache (``~/.cache/tina/autotune_torch.json``)
  stream.py     chunked streaming executor (offline-identical output)
  service.py    batched pipeline serving: fixed packing or continuous
                batching over a ladder of pre-compiled bucket plans, one
                CUDA stream per card with page-locked staging, admission
                control, deadlines, and batch-failure recovery (retry /
                bisect / degrade)
  errors.py     typed serving failures (Overloaded, DeadlineExceeded,
                InvalidRequest)
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
    runner = graph.ChunkedRunner(g, lowering="kernel")
    parts = [runner.push(c) for c in chunks]   # (16, n) chunks -> steps
    chunked = graph.stream_execute(g, x, chunk_len=2 ** 18,
                                   lowering="kernel")   # == power
    tuned = graph.compile(g, {"x": (16, 2 ** 22)}, lowering="auto")
    sharded = graph.compile(g, {"x": (16, 2 ** 22)}, lowering="kernel",
                            mesh=2)        # the batch over two cards
    svc = graph.PipelineService(g, 2 ** 22, batch_size=16,
                                batching="continuous", lowering="kernel")
    with svc:
        row = svc.submit(x0).result()   # x0: one (2 ** 22,) numpy signal

``device="cpu"`` runs any of these on the CPU (the kernels' plain
versions).
"""
from repro_torch.core.opdefs import OPDEFS, OpDef
from repro_torch.graph import (autotune, errors, pipelines, plan, service,
                               stream)
from repro_torch.graph.errors import (DeadlineExceeded, InvalidRequest,
                                      Overloaded, ServiceError)
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
from repro_torch.graph.service import (PipelineService, bucket_ladder,
                                       replay_batches)
from repro_torch.graph.stream import (ChunkedRunner, stream_execute,
                                      stream_spec)

__all__ = [
    "Graph", "Node", "load_graph", "OpDef", "OPDEFS", "Plan",
    "CompileOptions", "compile", "cache_stats", "clear_cache",
    "ChunkedRunner", "stream_execute", "stream_spec",
    "PipelineService", "bucket_ladder", "replay_batches",
    "ServiceError", "Overloaded", "DeadlineExceeded", "InvalidRequest",
    "BUILTINS",
    "build_pfb_power", "pfb_power_oracle", "build_spectrogram",
    "spectrogram_oracle", "build_fir_decimate", "fir_decimate_oracle",
    "build_stft_overlap_add", "stft_overlap_add_oracle", "build_correlate",
    "correlate_oracle", "build_cascaded_channelizer",
    "cascaded_channelizer_oracle", "autotune", "errors", "pipelines",
    "plan", "service", "stream",
]
