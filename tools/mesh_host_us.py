"""Host time a call of a batch-sharded plan, on an NVIDIA card, beside
the unsharded plan and the parts a sharded call adds.

Plans: ``pfb_power`` at the paper's Fig. 3 point (P = 32, M = 8, rows of
2**18 samples; host-bound) and ``fir_decimate`` (31 and 15 taps, rows of
2**22), each at the kernel lowering: unsharded at batch 1, on
``make_batch_mesh(1)`` at batch 1, and unsharded and on 4 logical shards
of the card (``BatchMesh((cuda:0,) * 4)``) at batch 4.  A call is timed
from its start to its return, with no synchronisation: blocks of 20
calls, the card drained between blocks (20 calls never fill the launch
queue), the kinds taken in turns block by block; the median over all
calls.  The parts (``part_us``), timed the same way: splitting the batch
(``BatchSharding.place``), reading the current streams, one
``Stream.wait_stream``, entering and leaving ``torch.cuda.device`` with
``torch.cuda.stream``, and one call of the per-shard plan on a shard's
stream.  ``--src`` imports the package from another tree's ``src``
directory (a parent unpacked with ``git archive``), so that two trees
are compared on one machine; run each tree in its own process.  Prints
one JSON line, with the card's name and power limit as ``nvidia-smi``
gives them.

    python3 tools/mesh_host_us.py [--src DIR] [--blocks 30]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCK = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory to import repro_torch from")
    ap.add_argument("--blocks", type=int, default=30,
                    help="blocks of 20 timed calls a kind")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("mesh_host_us: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch import graph
    from repro_torch.launch.mesh import BatchMesh, make_batch_mesh
    if not Path(graph.__file__).resolve().is_relative_to(src):
        print(f"mesh_host_us: imported {graph.__file__}, not from {src}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(kinds: dict) -> dict:
        """Median host us a call of each of ``kinds`` (name -> fn), the
        kinds in turns block by block, the card drained between blocks."""
        us = {k: [] for k in kinds}
        for fn in kinds.values():
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        for b in range(args.blocks):
            order = list(kinds.items())
            for name, fn in (order if b % 2 == 0 else order[::-1]):
                for _ in range(BLOCK):
                    t0 = time.perf_counter()
                    fn()
                    us[name].append((time.perf_counter() - t0) * 1e6)
                torch.cuda.synchronize()
        return {k: statistics.median(v) for k, v in us.items()}

    mesh1 = make_batch_mesh(1)
    mesh4 = BatchMesh((dev,) * 4)
    out = {"nvidia_smi": smi[0] if smi else None, "src": str(src),
           "torch": torch.__version__, "paths": {}}
    for name, g, n in (("pfb_power fig3", graph.build_pfb_power(32, 8),
                        2 ** 18),
                       ("fir_decimate", graph.build_fir_decimate(31, 15),
                        2 ** 22)):
        x1 = torch.randn(1, n, device=dev, generator=gen)
        x4 = torch.randn(4, n, device=dev, generator=gen)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            u1 = graph.compile(g, {"x": (1, n)}, lowering="kernel")
            s1 = graph.compile(g, {"x": (1, n)}, lowering="kernel",
                               mesh=mesh1)
            u4 = graph.compile(g, {"x": (4, n)}, lowering="kernel")
            s4 = graph.compile(g, {"x": (4, n)}, lowering="kernel",
                               mesh=mesh4)
        calls = timed({"unsharded_b1": lambda: u1(x1),
                       "mesh1_b1": lambda: s1(x1),
                       "unsharded_b4": lambda: u4(x4),
                       "shards4_b4": lambda: s4(x4)})
        side = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        sharding = s1.input_shardings[0]
        one = s1.shard_plans[dev]

        def contexts():
            with torch.cuda.device(dev), torch.cuda.stream(side):
                pass

        def on_side():
            with torch.cuda.device(dev), torch.cuda.stream(side):
                one(x1)

        parts = timed({"place": lambda: sharding.place(x1),
                       "current_stream": lambda: torch.cuda.current_stream(
                           dev),
                       "wait_stream": lambda: side.wait_stream(cur),
                       "device_and_stream_contexts": contexts,
                       "per_shard_plan_on_side_stream": on_side})
        out["paths"][name] = {"x": [n], "call_us": calls, "part_us": parts}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
