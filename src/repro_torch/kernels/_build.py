"""Build the CUDA sources under ``repro_torch/csrc/`` and load them.

``nvcc`` compiles every ``csrc/*.cu`` into an object, all sources at
once in parallel, and one more ``nvcc`` links them into a shared
library with a plain C interface, loaded with :mod:`ctypes`.  The
library lands in ``build/repro_torch/<hash>/`` at the checkout root,
keyed by a hash of the sources and the flags, so an edit rebuilds and
an unchanged tree reuses the last build.  Nothing is built at import:
:func:`lib` builds at first use, which only a CUDA tensor reaches.

No PyTorch headers are included, so a build takes seconds, not the
minutes ``torch.utils.cpp_extension`` would need.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libtina_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> (argtypes); every one returns its cudaError_t.
SIGNATURES = {
    # x, taps_rev, fr, fi (nullable), out, B, T, P, N, M, bt, bn,
    # complex_out, stream
    "tina_pfb": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # head, head_mode (0 real, 1 complex abs2, 2 real abs2), n, codes*,
    # consts*, operands**, n_steps, out, threads, stream
    "tina_chain": [_P, _I, ctypes.c_longlong, ctypes.POINTER(_I),
                   ctypes.POINTER(_F), ctypes.POINTER(_P), _I, _P, _I, _P],
    # x, y, out, n, cols, y_is_row, op (0 mul, 1 add), threads, stream
    "tina_binary": [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P],
    # x, x_is_complex, fr, fi, out, B, L, N, karatsuba, bm, bn, stream
    "tina_dft": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, y, rows, n, J, bt, bj, stream
    "tina_unfold": [_P, _P, _I, _I, _I, _I, _I, _P],
    # frames, out, rows, T, J, hop, threads, stream
    "tina_overlap_add": [_P, _P, _I, _I, _I, _I, _I, _P],
    # x, kern, out, rows, n, K, pad_left, pad_right, flip, bn, threads,
    # stream
    "tina_fir": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, y, out, M, N, K, bm, bn, bk, order_nm, stream
    "tina_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # xq, yq, sx, sy, out, M, N, K, bm, bn, bk, stream
    "tina_matmul_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # xq, fr, fi, sx, sr, si, out, B, L, N, bm, bn, bk, stream
    "tina_dft_int8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P],
    # x, tq, ts, out, rows, n, K, bn, threads, stream
    "tina_fir_int8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # frames, tq, ts, qr, qi, sr, si, out, B, T, P, N, M, bt, bn, stream
    "tina_pfb_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _P],
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
BUILD_INFO: dict = {}     # {"seconds", "dir", "ptxas", "cached"} of the load


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256()
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (or reuse) the shared library; returns its path.  Raises
    RuntimeError with nvcc's stderr if a compile or the link fails."""
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    so = out_dir / LIB_NAME
    if so.exists():
        BUILD_INFO.update(seconds=0.0, dir=str(out_dir), cached=True)
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for s in srcs:
        obj = out_dir / (s.stem + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(s), "-o", str(obj)]
        procs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    ptxas, failed = [], []
    for s, _, p in procs:
        out, err = p.communicate()
        ptxas.append(f"== {s.name}\n{out}{err}")
        if p.returncode != 0:
            failed.append(f"nvcc failed on {s.name} (rc {p.returncode}):\n"
                          f"{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (rc {link.returncode}):\n"
                           f"{link.stderr}")
    os.replace(tmp, so)          # atomic: a concurrent loader sees all or none
    BUILD_INFO.update(seconds=time.perf_counter() - t0, dir=str(out_dir),
                      ptxas="\n".join(ptxas), cached=False)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
        return _LIB


def check(code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


__all__ = ["build", "lib", "check", "sources", "BUILD_INFO", "BUILD_ROOT"]
