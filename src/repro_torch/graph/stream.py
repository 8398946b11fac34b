"""Streaming executor: run chunked 1-D signals through a pipeline in
bounded memory, with chunked output equal to offline whole-signal
execution.

Overlap-carry scheme: every streamable op advertises how it maps the
streamed (time) axis through the :class:`~repro_torch.core.opdefs.StreamRule`
on its OpDef --

  * ``block``      input samples consumed per output step (stride)
  * ``receptive``  input samples contributing to one output step
  * ``tail``       trailing axes the op appends after the time axis
                   (unfold/pfb emit (time, J|P) frames)

"time" rules spend these on the raw sample axis; "framed" rules
(frame_decimate's hop, overlap_add's K-frame reach) spend them on the
frame axis after an unfold/pfb.  Both compose down the chain as conv
stride and kernel arithmetic does (``R += (r-1)·B; B *= b``), giving the
whole pipeline's receptive field R and stride B in *input* samples.  An
overlap_add re-synthesizes the time axis (tail -= 1), emitting ``hop``
samples per step.  The runner keeps the last < R unconsumed samples as
carry; each push runs the compiled plan on the longest prefix that
yields whole output steps.  Every emitted step is computed from the same
input window the offline run uses, so concatenated chunked output equals
offline output (valid mode, no padding anywhere in the chain).

Plans come from :func:`repro_torch.graph.plan.compile`, so pushes of
equal size after the first are plan-cache hits.  ``CompileOptions`` pass
through as they are: ``lowering="kernel"`` runs the CUDA kernels on
every push, ``lowering="auto"`` / ``block_configs="auto"`` the tuner's
winners (tuned once per push shape, then cached), and
``precision="bf16"|"int8"`` streams at a reduced tier.  Streamed output
equals offline output at every tier: bf16 rounding is pointwise, and
int8 activations are quantized per row, per FIR window or per (frame,
branch), so each emitted window quantizes only over samples that the
offline run feeds the same op.

Carry: it lives on the runner's device as a tensor, so a push on the
card moves only its own chunk (a numpy chunk is copied to the device
once, on entry) and the window is a slice of ``torch.cat([carry,
chunk])``.

Batched chunks: ``(batch, chunk_len)`` pushes work as 1-D ones; the
carry arithmetic runs on the last axis and the batch rides along.  The
window of a batched buffer, ``buf[..., :use]``, is a view whose row
stride is the buffer's length, not ``use``.  No kernel wrapper of
:mod:`repro_torch.kernels` reads a row stride: each takes dense rows and
raises on a strided view, and the wrappers the ``kernel`` lowering calls
(:mod:`repro_torch.kernels.ops`: ``fir``, ``pfb``, ``unfold``, ``qfir``,
``qpfb``, ``_binary``, ``fused_elementwise``, ``dft``, ``matmul``, ...)
copy such a view into dense rows first, as they do for any strided
input.  So the first node of a batched push copies its window once; a
1-D window is dense already.

Bucketed pushes: ``ChunkedRunner(..., step_buckets=True)`` quantizes
every push to a power-of-two number of output steps (the remainder stays
in the carry; ``finalize()``/``run()`` drains it).  Irregular push sizes
then compile a bounded ladder of plan shapes instead of one plan per
distinct chunk length.  Each plan holds its own consts, and its kernel
packs (the int8 weight packs, the TF32 planes of a const y) are made at
its first launch, so on the card this also bounds the memory the plans
hold.

Sharded batched streams: a runner built with ``mesh=`` (a BatchMesh or
a device count) takes ``(batch, chunk_len)`` chunks whose batch the
shard count divides.  It normalizes the mesh once, keeps shard i's carry
on the mesh's device i, and runs every push through the sharded plan's
``run_shards`` (the per-shard plan on each shard's window); a push
returns the shards' steps gathered on the mesh's first device.  The
carry arithmetic is the unsharded one (the overlap lives on the time
axis, the batch rides along), so the output still equals offline, and
``step_buckets`` quantizes every shard's window alike.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core.opdefs import OPDEFS
from repro_torch.graph import plan as plan_lib
from repro_torch.graph.graph import Graph, Node
from repro_torch.launch.mesh import BatchSharding, Shards


def _taps_shape(graph: Graph, node: Node) -> tuple:
    ref = node.inputs[1]
    if graph.nodes[ref].op != "const":
        raise ValueError(
            f"streaming requires const taps for {node.name} ({node.op})")
    return graph.consts[ref].shape


@dataclasses.dataclass(frozen=True)
class PipeStreamSpec:
    block: int         # pipeline stride, in input samples per output step
    receptive: int     # input samples contributing to one output step
    tail_dims: int     # axes after the time axis in the final output

    @property
    def concat_axis(self) -> int:
        return -(1 + self.tail_dims)


def stream_spec(graph: Graph) -> PipeStreamSpec:
    """Compose per-op specs along the (unique) path from the stream input
    to the output.  Raises if the graph isn't streamable."""
    if len(graph.inputs) != 1:
        raise ValueError("streaming supports single-input graphs "
                         "(bake taps/windows as consts)")
    if len(graph.outputs) != 1:
        raise ValueError("streaming supports single-output graphs")
    streamed = {graph.inputs[0]}
    b_total, r_total, tail = 1, 1, 0
    deframed = False      # an overlap_add ran: steps are now multi-sample
    for node in graph.topo():
        hot = [i for i in node.inputs if i in streamed]
        if not hot:
            continue
        d = OPDEFS.get(node.op)
        rule = d.stream if d is not None else None
        if rule is None:
            raise ValueError(f"{node.name} ({node.op}) is not streamable")
        if len(hot) > 1 and rule.kind != "pointwise":
            raise ValueError(f"{node.name}: multiple streamed inputs")
        if rule.kind in ("time", "framed"):
            if rule.kind == "time" and tail:
                raise ValueError(
                    f"{node.name} ({node.op}) reads the time axis, but an "
                    "upstream op already framed it")
            if rule.kind == "time" and deframed:
                raise ValueError(
                    f"{node.name} ({node.op}) reads the time axis after an "
                    "overlap-add re-synthesized it (multi-sample steps); "
                    "not streamable")
            if rule.kind == "framed" and not tail:
                raise ValueError(
                    f"{node.name} ({node.op}) consumes the frame axis; "
                    "insert an unfold/pfb first")
            taps = (_taps_shape(graph, node) if rule.needs_taps else None)
            b, r, dt = rule.spec(d.bind(node.attr), taps)
            r_total += (r - 1) * b_total
            b_total *= b
            tail += dt
            if dt < 0:
                deframed = True
        elif rule.kind == "frame":
            if not tail:
                raise ValueError(
                    f"{node.name} ({node.op}) mixes the streamed axis; "
                    "insert an unfold/pfb first")
        streamed.add(node.name)
    if graph.outputs[0] not in streamed:
        raise ValueError("output does not depend on the stream input")
    return PipeStreamSpec(b_total, r_total, tail)


class ChunkedRunner:
    """Push chunks in, get output steps out; carries FIR/PFB/unfold
    overlap state so the concatenated output equals offline execution.

    ``options`` (or keyword arguments naming its fields, as ``compile``
    takes them) say how every push's plan is compiled; its ``device``
    (default ``"cuda"``) is where the carry lives and the plans run, and
    under ``mesh=`` each shard's carry lives on its own device."""

    def __init__(self, graph: Graph, *,
                 options: plan_lib.CompileOptions | None = None,
                 mesh=None, step_buckets: bool = False, **compile_opts):
        self.graph = graph
        self.spec = stream_spec(graph)
        if mesh is not None:
            compile_opts["mesh"] = mesh
        if compile_opts:
            if options is not None:
                raise TypeError(
                    "ChunkedRunner got both options= and compile keyword "
                    f"argument(s) {sorted(compile_opts)}: fold everything "
                    "into the CompileOptions")
            options = plan_lib.CompileOptions(**compile_opts)
        options = options or plan_lib.CompileOptions()
        plan_lib._check_ported(options)
        # the mesh is made once: every push re-enters compile, and steady
        # pushes must stay cache hits, not rebuild a mesh per chunk
        self.options, self.mesh, self.device = plan_lib.normalize_mesh(
            options)
        # step_buckets: quantize each push to a power-of-two number of
        # output steps (carrying the remainder) so irregular push sizes
        # compile a bounded LADDER of plan shapes instead of one plan per
        # distinct length.  finalize() (called by run()) drains the
        # deferred remainder, so concatenated output still equals offline.
        self.step_buckets = bool(step_buckets)
        self.window_lens: set[int] = set()   # distinct compiled windows
        # the carry: one tensor per shard, each on its shard's device
        self._carry: list[torch.Tensor] | None = None
        self._seq = 0    # pushes so far: the push spans' shared identifier

    @property
    def carry_len(self) -> int:
        return 0 if self._carry is None else self._carry[0].shape[-1]

    def _split(self, x) -> list[torch.Tensor]:
        """``x`` as the runner's shards: one tensor on the runner's
        device, or a batch split across the mesh."""
        if self.mesh is None:
            return [torch.as_tensor(x, device=self.device)]
        return list(BatchSharding(self.mesh).place(x))

    def push(self, chunk, *, final: bool = False) -> torch.Tensor | None:
        """Append ``chunk`` (numpy or tensor, ``(..., n)``; under a mesh
        ``(batch, n)``) to the carry and run every whole output step it
        completes; None when it completes none."""
        return self._push(self._split(chunk), final)

    def _push(self, parts: list, final: bool) -> torch.Tensor | None:
        seq, self._seq = self._seq, self._seq + 1
        # stream.carry: the carry joined to the chunk, the window cut and
        # the next carry sliced; stream.push then times the plan's lookup
        # and run, beside it and not around it
        with obs.span("stream.carry", cat="stream", seq=seq):
            bufs = (parts if self._carry is None
                    else [torch.cat([c, p], dim=-1)
                          for c, p in zip(self._carry, parts)])
            r, b = self.spec.receptive, self.spec.block
            if bufs[0].shape[-1] < r:
                self._carry = bufs
                return None
            n_steps = (bufs[0].shape[-1] - r) // b + 1
            if self.step_buckets and not final:
                n_steps = 1 << (n_steps.bit_length() - 1)  # largest 2^k <= n
            use = r + (n_steps - 1) * b
            windows = [buf[..., :use] for buf in bufs]
            carry = [buf[..., n_steps * b:] for buf in bufs]
            self.window_lens.add(int(use))
            shape = tuple(windows[0].shape)
            if self.mesh is not None:
                shape = (shape[0] * len(windows),) + shape[1:]
        with obs.span("stream.push", cat="stream", graph=self.graph.name,
                      steps=int(n_steps), window=int(use), seq=seq):
            # the dtype as compile's default spells it ("float32"), so a
            # push shares the plan an offline compile of its shape made
            dtype = str(windows[0].dtype).removeprefix("torch.")
            p = plan_lib.compile(
                self.graph, {self.graph.inputs[0]: shape},
                options=self.options.replace(dtype=dtype))
            out = (p(windows[0]) if self.mesh is None
                   else p.gather(p.run_shards(Shards(windows))))
        self._carry = carry
        return out

    def finalize(self) -> torch.Tensor | None:
        """Emit every whole output step still held in the carry.  Only a
        ``step_buckets`` runner ever defers whole steps (sub-bucket
        remainders); for others this is a no-op returning None."""
        if self._carry is None:
            return None
        return self._push([c[..., :0] for c in self._carry], True)

    def run(self, x, chunk_len: int) -> torch.Tensor:
        """Stream ``x`` through in ``chunk_len`` pieces; concatenate
        (finalizing any bucket-deferred remainder).  ``x`` is moved to
        the runner's device (under a mesh: split across it) once."""
        parts = self._split(x)
        n = parts[0].shape[-1]
        outs = []
        for i in range(0, n, chunk_len):
            o = self._push([p[..., i:i + chunk_len] for p in parts], False)
            if o is not None:
                outs.append(o)
        o = self.finalize()
        if o is not None:
            outs.append(o)
        if not outs:
            raise ValueError(
                f"signal length {n} is shorter than the "
                f"pipeline's receptive field ({self.spec.receptive}): "
                "no output steps were produced")
        return torch.cat(outs, dim=self.spec.concat_axis)


def stream_execute(graph: Graph, x, chunk_len: int, *,
                   options: plan_lib.CompileOptions | None = None,
                   **compile_opts) -> torch.Tensor:
    """One-shot helper: chunked execution of ``x`` (tests/benchmarks)."""
    return ChunkedRunner(graph, options=options, **compile_opts).run(
        x, chunk_len)


__all__ = ["ChunkedRunner", "PipeStreamSpec", "stream_spec",
           "stream_execute"]
