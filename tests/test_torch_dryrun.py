"""The port's dry-run (``repro_torch.launch.shapes``, ``launch.dryrun``)
against the JAX package's: the shape grid, the parameter counts, and the
FLOPs the port's steps run, counted on meta tensors.

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host
devices when it is imported; the fixture below imports it after JAX has
made its backend and puts the variable back, so the worker's JAX keeps
its one device.
"""
import os
import resource

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.analysis import roofline as jroofline
from repro.launch import shapes as jshapes
from repro_torch import configs as tconfigs
from repro_torch.analysis import roofline as troofline
from repro_torch.analysis import summarize
from repro_torch.launch import dryrun, shapes
from repro_torch.models import model as tmodel
from repro_torch.tree import leaves

ARCHS = tconfigs.ARCHS


@pytest.fixture(scope="module")
def jdryrun():
    jax.devices()                       # the backend, made with this env
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return mod


# ---------------------------------------------------------------------------
# the shape grid (tests/test_archs.py's three shape tests, on the port)
# ---------------------------------------------------------------------------
def test_encoder_only_has_no_decode_cells():
    cfg = tconfigs.get("hubert_xlarge")
    assert shapes.skip_reason(cfg, shapes.SHAPES["decode_32k"])
    assert shapes.skip_reason(cfg, shapes.SHAPES["long_500k"])
    assert shapes.skip_reason(cfg, shapes.SHAPES["train_4k"]) is None


def test_long_context_only_subquadratic():
    runnable = [a for a in ARCHS if shapes.skip_reason(
        tconfigs.get(a), shapes.SHAPES["long_500k"]) is None]
    assert sorted(runnable) == ["recurrentgemma_9b", "rwkv6_3b"]


def test_grid_has_31_runnable_cells():
    rows = list(shapes.cells(ARCHS))
    assert len(rows) == 40
    assert sum(1 for *_, skip in rows if skip is None) == 31


def test_grid_equals_reference_row_for_row():
    def rows(mod):
        return [(a, (c.name, c.kind, c.seq_len, c.global_batch), skip)
                for a, c, skip in mod.cells(ARCHS)]
    assert rows(shapes) == rows(jshapes)
    assert {k: tuple(vars(v).values()) for k, v in shapes.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in jshapes.SHAPES.items()}


# ---------------------------------------------------------------------------
# parameter counts (tests/test_dryrun_unit.py's, and the reference's own)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_reference(jdryrun, arch):
    """Exact integers: the port's training-layout tree on fake tensors
    against ``jax.eval_shape`` of the reference's."""
    got = dryrun.count_params(tconfigs.get(arch))
    want = jdryrun.count_params(jconfigs.get(arch))
    assert got == want
    assert all(float(int(x)) == x for x in got)


def test_count_params_olmo_matches_hand_count():
    total, active = dryrun.count_params(tconfigs.get("olmo_1b"))
    d, ff, v, L = 2048, 8192, 50304, 16
    approx = v * d + L * (4 * d * d + 3 * d * ff)
    assert abs(total - approx) / approx < 0.01
    assert active == total


def test_count_params_kimi_active_fraction():
    total, active = dryrun.count_params(tconfigs.get("kimi_k2_1t_a32b"))
    assert total > 0.9e12, f"kimi should be ~1T params, got {total:.3g}"
    assert active < 0.06 * total, (total, active)


# ---------------------------------------------------------------------------
# FLOPs on meta tensors against the hand count
# ---------------------------------------------------------------------------
def _olmo(**over):
    return tconfigs.get_reduced("olmo_1b").scaled(**over)


def _hand(cfg, b, s):
    """(N, N_stack, per-layer d_ff weights, attention FLOPs of one
    forward) for reduced olmo (tied table, h * hd == d): the attention's
    two einsums over the whole (b, s, s) score block, per layer."""
    d, ff, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    assert cfg.n_heads * cfg.head_dim == d and cfg.tie_embeddings
    n_stack = L * (4 * d * d + 3 * d * ff)
    attn = L * 2 * (2 * b * cfg.n_heads * s * s * cfg.head_dim)
    return v * d + n_stack, n_stack, L * d * ff, attn


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_flops_match_hand_count(remat):
    """6·N·T plus attention (forward and its two backward products); with
    remat, the recompute of each superblock's forward but its final down
    projection (torch's checkpoint stops at the last tensor the backward
    needs) and of its attention."""
    cfg = _olmo(remat=remat)
    b, s = 4, 32
    n, n_stack, down, attn = _hand(cfg, b, s)
    got = dryrun._cell_metrics(cfg, shapes.ShapeCell("t", "train", s, b))
    want = jroofline.model_flops(n, 0, b * s, "train") + 3 * attn
    if remat:
        want += 2 * (n_stack - down) * b * s + attn
    assert got["flops"] == want


def test_decode_step_flops_match_hand_count():
    """2·N a token plus the attention's two products against the whole
    cache, per layer."""
    cfg = _olmo()
    b, cache = 4, 48
    n, _, _, _ = _hand(cfg, b, 1)
    attn = cfg.n_layers * 2 * (2 * b * cfg.n_heads * cache * cfg.head_dim)
    got = dryrun._cell_metrics(cfg, shapes.ShapeCell("d", "decode", cache, b))
    assert got["flops"] == jroofline.model_flops(n, 0, b, "decode") + attn


@pytest.mark.parametrize("arch,layers", [("olmo_1b", 4),
                                         ("recurrentgemma_9b", 14),
                                         ("rwkv6_3b", 4),
                                         ("kimi_k2_1t_a32b", 4)])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_probes_equal_full_count(arch, layers, kind):
    """The 1- and 2-superblock probes, extrapolated to 4 repeats (and
    recurrentgemma's 2-layer tail), give the full step's FLOPs, op bytes,
    operands and results exactly.  The peak's temporaries are not linear
    in depth (the phase that holds the peak moves), so the probes'
    ``temp_size_in_bytes`` is an estimate and is not held here."""
    cfg = tconfigs.get_reduced(arch).scaled(n_layers=layers)
    assert tmodel._pattern_layout(cfg)[1] == 4
    cell = shapes.ShapeCell("p", kind, 24, 2)
    probed = dryrun.cell_counts(cfg, cell)
    full = dryrun.cell_counts(cfg, cell, scan_correct=False)
    assert probed["flops"] == full["flops"]
    assert probed["bytes"] == full["bytes"]
    pm, fm = dict(probed["memory"]), dict(full["memory"])
    assert pm.pop("temp_size_in_bytes") > 0 < fm.pop("temp_size_in_bytes")
    assert pm == fm


def test_build_step_operands_are_meta():
    for kind in ("train", "prefill", "decode"):
        _, ops = dryrun.build_step(tconfigs.get("qwen2_7b"),
                                   shapes.ShapeCell("m", kind, 4096, 64))
        ts = [t for t in leaves(ops) if isinstance(t, torch.Tensor)]
        assert ts and all(t.device.type == "meta" for t in ts)


def _with_copy(tree) -> list:
    """Every dict of ``tree`` that holds a ``wt`` copy."""
    if isinstance(tree, dict):
        own = [tree] if "wt" in tree else []
        return own + [p for v in tree.values() for p in _with_copy(v)]
    if isinstance(tree, (list, tuple)):
        return [p for v in tree for p in _with_copy(v)]
    return []


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_reads_prepared_copies_not_masters(kind):
    """Serving's operands are ``prepare``'s, as the port serves: every
    linear holds its f32 ``w`` and its bf16 K-major ``wt``, the step
    reads only ``wt``, so the unread operands are exactly the masters,
    and the roofline's memory term counts the rest (olmo_1b at full
    width, bf16 compute; the train step reads every operand)."""
    cfg = tconfigs.get("olmo_1b")
    cell = shapes.ShapeCell("s", kind, 32, 2)
    _, (params, *_) = dryrun.build_step(cfg, cell)
    linears = _with_copy(params)
    assert len(linears) == 7 * cfg.n_layers
    assert all(p["wt"].dtype == torch.bfloat16
               and p["w"].dtype == torch.float32 for p in linears)
    masters = sum(p["w"].nbytes for p in linears)
    m = dryrun._cell_metrics(cfg, cell)["memory"]
    assert m["unread_argument_size_in_bytes"] == masters
    row = dryrun.run_cell("olmo_1b", cell, scan_correct=False)
    assert row["memory"] == m
    read = (m["argument_size_in_bytes"] - masters + m["output_size_in_bytes"]
            + 2 * m["temp_size_in_bytes"])
    assert row["t_memory_refined_ms"] == pytest.approx(
        read / troofline.HW.hbm_bw * 1e3, rel=1e-12)
    train = dryrun._cell_metrics(_olmo(), shapes.ShapeCell("t", "train",
                                                           32, 2))
    assert train["memory"]["unread_argument_size_in_bytes"] == 0


# ---------------------------------------------------------------------------
# a row, the CLI and the summary
# ---------------------------------------------------------------------------
def _reference_keys() -> set:
    rep = jroofline.RooflineReport(arch="a", shape="s", mesh="m", chips=1,
                                   hlo_flops=1.0, hlo_bytes=1.0)
    return set(rep.row()) | {"kind", "status", "skip_reason", "mesh_shape",
                             "n_params", "n_active", "tokens",
                             "t_compile_s", "t_probe_s", "memory", "hbm_ok"}


def test_run_cell_row_has_reference_keys_and_allocates_nothing():
    """olmo_1b's train_4k at full width (256 x 4096 tokens: terabytes of
    activations if anything were allocated) leaves the peak RSS within
    a GB."""
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    row = dryrun.run_cell("olmo_1b", "train_4k")
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0
    assert grown_kb < 1_000_000
    assert set(row) == _reference_keys()
    assert row["status"] == "ok" and row["chips"] == 1
    assert row["mesh"] == "h100x1" and row["bottleneck"] == "compute"
    assert row["tokens"] == 256 * 4096
    assert row["hbm_ok"] is False        # sized for a pod, not one card
    n, n_stack, down, attn = _hand(tconfigs.get("olmo_1b"), 256, 4096)
    t = 256 * 4096
    assert row["n_params"] == n
    assert row["model_gflops"] * 1e9 == 6 * n * t
    # 6·N·T, remat's recompute, and attention four times (forward,
    # recompute, two backward products)
    assert row["hlo_gflops_per_chip"] * 1e9 == \
        6 * n * t + 2 * (n_stack - down) * t + 4 * attn
    skip = dryrun.run_cell("olmo_1b", "long_500k")
    assert skip["status"] == "skip" and skip["skip_reason"]


def test_main_writes_rows_summarize_renders(tmp_path, capsys):
    out = str(tmp_path / "dr")
    assert dryrun.main(["--arch", "stablelm_1_6b", "--shape", "decode_32k",
                        "--out", out]) == 0
    assert dryrun.main(["--arch", "hubert_xlarge", "--shape", "decode_32k",
                        "--out", out, "--tag", "v"]) == 0
    assert sorted(os.listdir(out)) == [
        "hubert_xlarge__decode_32k__h100x1__v.json",
        "stablelm_1_6b__decode_32k__h100x1.json"]
    rows = summarize.load(out)
    assert [r["status"] for r in rows] == ["skip", "ok"]
    assert rows[1]["hbm_gb"] > 0
    table = summarize.fmt(rows, md=True)
    assert table.count("\n") == 3 and "| stablelm_1_6b |" in table
    assert dryrun.main(["--arch", "stablelm_1_6b", "--shape", "decode_32k",
                        "--out", out, "--skip-existing"]) == 0
    assert "[cached]" in capsys.readouterr().out
