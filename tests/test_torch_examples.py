"""The examples' twins on the port (``examples/torch_*.py``): each runs
as a subprocess, as a user runs it, at a tiny size with ``--device
cpu``, exits 0 and prints its JAX original's OK lines.  The ``cuda``
cases run each at its default size on the card (skipped without one):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_examples.py

The file imports neither JAX nor the JAX package.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TWINS = ("torch_quickstart", "torch_pipeline_quickstart",
         "torch_serve_batched", "torch_pfb_features", "torch_train_lm")
# each twin's tiny CPU size, and the lines its original prints when it
# passes
CPU_ARGS = {
    "torch_quickstart": [],
    "torch_pipeline_quickstart": [],
    "torch_serve_batched": ["--batch", "2", "--prompt-len", "8",
                            "--new-tokens", "4"],
    "torch_pfb_features": [],
    "torch_train_lm": ["--steps", "2", "--batch-size", "2", "--seq-len",
                       "16"],
}
OK_LINES = {
    "torch_quickstart": ["== TINA arithmetic functions (paper §3) ==",
                         "== PFB use case (paper §5.2) ==",
                         "quickstart: all mappings verified"],
    "torch_pipeline_quickstart": ["equals offline",
                                  "pipeline quickstart: all stages "
                                  "verified"],
    "torch_serve_batched": ["arch=olmo-1b  prefill 2x8", "decode 3 steps",
                            "sample generations (token ids):", "  seq1: "],
    "torch_pfb_features": ["PFB channelizer: (2, 16832) samples -> "
                           "(2, 256, 64)", "(decreased: True)"],
    "torch_train_lm": ["trained tiny for"],
}


def _run(name, args, tmp_path, ok_lines):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["TINA_AUTOTUNE_CACHE"] = str(tmp_path / "autotune.json")
    if name == "torch_train_lm":
        args = args + ["--workdir", str(tmp_path / "run")]
    r = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py"),
                        *args], capture_output=True, text=True, env=env,
                       cwd=str(tmp_path), timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    for line in ok_lines:
        assert line in r.stdout, (line, r.stdout)
    assert "MISMATCH" not in r.stdout
    return r.stdout


@pytest.mark.parametrize("name", TWINS)
def test_twin_on_cpu(name, tmp_path):
    out = _run(name, CPU_ARGS[name] + ["--device", "cpu"], tmp_path,
               OK_LINES[name])
    if name == "torch_quickstart":
        assert out.count(" OK\n") == 14      # 3 ops x 3 lowerings + 5


def test_twins_import_neither_jax_nor_reference():
    """The twins and this slice's modules, as the port's files are
    checked in ``tests/test_torch_plan.py``."""
    files = [ROOT / "examples" / f"{n}.py" for n in TWINS] + [
        ROOT / "src" / "repro_torch" / f for f in (
            "launch/shapes.py", "launch/dryrun.py", "analysis/__init__.py",
            "analysis/roofline.py", "analysis/summarize.py",
            "partitioning.py",
            "distributed/sharding.py", "distributed/pipeline.py")]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            bad += [(f.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_twin_refuses_cuda_without_a_card(tmp_path):
    """An entry point asked for the card without one raises; nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable,
                        str(ROOT / "examples" / "torch_quickstart.py")],
                       capture_output=True, text=True, env=env,
                       cwd=str(tmp_path), timeout=300)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", TWINS)
def test_twin_on_card(card, name, tmp_path):
    """Each twin at its default size on the card (``--device cuda``, the
    default)."""
    ok = {**OK_LINES,
          "torch_serve_batched": ["arch=olmo-1b  prefill 4x32",
                                  "decode 47 steps", "kernel lowering",
                                  "sample generations (token ids):"],
          "torch_train_lm": ["trained tiny for 200 steps"]}
    _run(name, [], tmp_path, ok[name])
