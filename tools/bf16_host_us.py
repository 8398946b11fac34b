"""Host time a call of the bf16 GEMM's wrapper, on an NVIDIA card.

Times ``repro_torch.kernels.matmul.matmul`` at olmo_1b's dense GEMM
shapes, as ``models/layers.py:linear`` calls it (x bf16 against a
weight's K-major copy passed as ``yt``): decode at 8 rows, prefill at
8 x 512.  A call is timed from its start to its return, with no
synchronisation: blocks of 50 calls, the card drained between blocks
(50 launches never fill the launch queue), the median and the 10th and
90th percentiles over all calls.  The C entry ``tina_matmul_bf16`` is
timed the same way on its own (``entry_us_*``: the launch without the
wrapper's checks and output allocation), with the arguments the
wrapper passes it: the route's (kind, width, splits, chunks) where the
tree has ``_bf16_launch_args``, else its one tile (bm, bn, bk).
``--src`` imports the package from another tree's ``src`` directory (a
parent commit unpacked with ``git archive``), so that two trees are
compared on one machine; run each tree in its own process.  Prints one JSON line, with the card's name and
power limit as ``nvidia-smi`` gives them.

    python3 tools/bf16_host_us.py [--src DIR] [--blocks 40]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# olmo_1b's dense layers as (K, N): wq/wk/wv/wo, up/gate, down
SHAPES = {"qkvo": (2048, 2048), "up_gate": (2048, 8192),
          "down": (8192, 2048)}
ROWS = {"decode": 8, "prefill": 8 * 512}
BLOCK = 50


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory to import repro_torch from")
    ap.add_argument("--blocks", type=int, default=40,
                    help="blocks of 50 timed calls a shape")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("bf16_host_us: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import matmul as mmk
    if not Path(mmk.__file__).resolve().is_relative_to(src):
        print(f"bf16_host_us: imported {mmk.__file__}, not from {src}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for where, m in ROWS.items():
        for name, (k, n) in SHAPES.items():
            x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
            wt = (torch.randn(n, k, device="cuda", generator=gen)
                  * k ** -0.5).bfloat16()
            y = wt.t()
            out = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
            route = (mmk._bf16_launch_args(m, n, k)
                     if hasattr(mmk, "_bf16_launch_args")
                     else mmk.bf16_tile())
            stream = torch.cuda.current_stream().cuda_stream
            lib = _build.lib()

            def entry():
                _build.check(lib.tina_matmul_bf16(
                    x.data_ptr(), wt.data_ptr(), out.data_ptr(), m, n, k,
                    *route, stream), "matmul_bf16")

            rec = {"where": where, "gemm": name, "mkn": [m, k, n],
                   "entry_args": list(route)}
            for key, fn in (("host", lambda: mmk.matmul(x, y, yt=wt)),
                            ("entry", entry)):
                for _ in range(5):      # the build and first launches
                    fn()
                torch.cuda.synchronize()
                host = []
                for _ in range(args.blocks):
                    for _ in range(BLOCK):
                        t0 = time.perf_counter()
                        fn()
                        host.append(time.perf_counter() - t0)
                    torch.cuda.synchronize()
                q = statistics.quantiles(host, n=10)
                rec.update({f"{key}_us_median": statistics.median(host) * 1e6,
                            f"{key}_us_p10": q[0] * 1e6,
                            f"{key}_us_p90": q[-1] * 1e6})
            rec["calls"] = len(host)
            rows.append(rec)
            del x, wt, y, out
    print(json.dumps({"src": str(src), "nvidia_smi": smi[0] if smi else None,
                      "torch": torch.__version__, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
