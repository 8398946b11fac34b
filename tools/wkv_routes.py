"""Device ms of rwkv6's two WKV forward kernels against the sequence
length on an NVIDIA card: the recurrent kernel and the chunk-parallel
one (``kernels/wkv.py:forward_kernel``) at batch 8 x S x 40 heads x 64
(rwkv6-3b's widths), S from 1 to 512, each beside the bytes bound and
the route ``kernels/wkv.py:route`` takes; the lengths where the chunked
kernel is the faster set ``CHUNKED_MIN_STEPS``.  One JSON line a length,
then one with the card's name and power limit as ``nvidia-smi`` gives
them.

    python3 tools/wkv_routes.py [--batch 8] [--heads 40]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LENGTHS = (1, 8, 16, 24, 32, 40, 48, 56, 64, 96, 128, 256, 512)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=40)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("wkv_routes: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build, wkv

    _build.lib()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(cs.WKV_SEED)
    for s in LENGTHS:
        shape = (args.batch, s, args.heads, 64)
        ins = cs.wkv_inputs(torch, gen, *shape, True)
        rec = {"shape": list(shape), "route": wkv.route(s, 64),
               "bound_ms": cs.bound(*cs.wkv_cost(*shape, False))[0]}
        for kind in wkv.ROUTES:
            rec[f"{kind}_ms"] = cs.device_ms(
                torch, lambda: wkv.forward_kernel(*ins, 0, kind))
        print(json.dumps(rec), flush=True)
    print(json.dumps({"nvidia_smi": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
