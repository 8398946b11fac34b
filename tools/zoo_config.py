"""One model-zoo config's serving run on an NVIDIA card, from a given tree.

Runs ``chip_smoke.lm_zoo_config`` of the tree at ``--root`` (its
``chip_smoke.py`` and its ``src``) for ``--arch`` at ``--layers``
layers, published widths: prefill 8 x 512 then 8 greedy steps at the
kernel lowering, with that phase's checks; its JSON line (prefill and
decode ms, the profiled decode step's busy ms and launches) goes to
stdout as chip_smoke prints it.  For rwkv6 it then times one call of
the model's WKV scan (``models/rwkv6.py:_wkv_scan``) at a decode step,
8 x 1 x 40 heads x 64, from its start to its return, over 2000 calls
with no synchronisation (``wkv_decode_host_us``); with ``--wkv-phase``
it then runs the tree's chip_smoke ``wkv`` phase (the WKV kernels
against the plain loop, their device ms, rwkv6's 2-layer train step).
Run a parent commit
unpacked with ``git archive`` and this tree in turns, each in its own
process (parent, tree, tree, parent), to compare two trees on one card.
Prints one JSON line more, with the card's name and power limit as
``nvidia-smi`` gives them.

    python3 tools/zoo_config.py [--root DIR] [--arch rwkv6_3b] [--layers 32]
                                [--wkv-phase]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 2000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--arch", default="rwkv6_3b")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--wkv-phase", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("zoo_config: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.models import rwkv6

    _build.lib()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    launched = cs.lm_zoo_config(torch, dev, card, cs.zero_counts, cs.counts,
                                args.arch, args.layers, None)
    out = {"root": str(root), "arch": args.arch, "layers": args.layers,
           "launches": launched if isinstance(launched, dict)
           else {"matmul_bf16": launched}, "nvidia_smi": card}
    if args.arch == "rwkv6_3b":
        g = torch.Generator(device=dev).manual_seed(0)
        ins = [torch.randn(8, 1, 40, 64, device=dev, generator=g)
               for _ in range(4)]
        ins += [torch.randn(40, 64, device=dev, generator=g),
                torch.randn(8, 40, 64, 64, device=dev, generator=g)]
        for _ in range(20):
            rwkv6._wkv_scan(*ins)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            rwkv6._wkv_scan(*ins)
        out["wkv_decode_host_us"] = (time.perf_counter() - t0) / CALLS * 1e6
        torch.cuda.synchronize()
    if args.wkv_phase:
        out["wkv_rows"] = cs.wkv_phase(torch, dev, card, cs.zero_counts,
                                       cs.counts, {args.arch: out["launches"]})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
