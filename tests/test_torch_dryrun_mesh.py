"""The port's dry-run over the production meshes
(``repro_torch.launch.dryrun`` at ``--mesh single|multi|both``): rows
against the reference's, per-card counts against hand counts and the
one-card count, the collectives a sharded step records
(``distributed/collectives.recording``) and their cost
(``analysis/roofline.add_collective``), the one-data-row shortcut
(``launch/mesh.RowMesh``) against the whole mesh, and ``--multi-pod``.

Every count runs on meta tensors at reduced configs (the CLI's cells
through ``dryrun.get`` patched to ``configs.get_reduced``); the
reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host
devices when imported, so it is imported as ``tests/test_torch_dryrun.py``
imports it.
"""
import json
import os

import pytest
import torch

from repro import configs as jconfigs
from repro.analysis import roofline as jroofline
from repro.launch import shapes as jshapes
from repro_torch import configs as tconfigs
from repro_torch.analysis import roofline as troofline
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import step as step_lib
from repro_torch.launch import dryrun, shapes
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import (RowMesh, make_mesh, mesh_from_args,
                                     make_production_mesh)
from repro_torch.tree import leaves

from test_torch_dryrun import _reference_keys, jdryrun  # noqa: F401

# 6 heads of 32 on 2 KV heads: 1.5 heads a rank at TP 4, KV heads straddled
_SIX_HEADS = dict(d_model=192, n_heads=6, n_kv_heads=2)
PODS = {"pod16x16": ({"data": 16, "model": 16}, 256),
        "pod2x16x16": ({"pod": 2, "data": 16, "model": 16}, 512)}


def _meta(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_mesh(shape, axes, "meta")


def _olmo(**over):
    return tconfigs.get_reduced("olmo_1b").scaled(**over)


@pytest.fixture
def reduced(monkeypatch):
    """The dry-run's cells at the reduced configs."""
    monkeypatch.setattr(dryrun, "get", tconfigs.get_reduced)


# ---------------------------------------------------------------------------
# rows against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", sorted(PODS))
@pytest.mark.parametrize("arch,shape", [("qwen2_7b", "decode_32k"),
                                        ("olmo_1b", "train_4k")])
def test_row_matches_reference_row(jdryrun, reduced, mesh, arch, shape):
    """The reference's keys, mesh name, shape and chip count; parameter
    counts and model FLOPs equal the reference's for the same config and
    cell; the collective terms nonzero."""
    row = dryrun.run_cell(arch, shape, mesh=mesh)
    mesh_shape, chips = PODS[mesh]
    assert set(row) == _reference_keys()
    assert row["status"] == "ok" and row["mesh"] == mesh
    assert row["mesh_shape"] == mesh_shape and row["chips"] == chips
    jcfg = jconfigs.get_reduced(arch)
    n, active = jdryrun.count_params(jcfg)
    assert (row["n_params"], row["n_active"]) == (n, active)
    cell = jshapes.SHAPES[shape]
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    assert row["tokens"] == tokens
    assert row["model_gflops"] == jroofline.model_flops(
        n, active, tokens, cell.kind) / 1e9
    # a 16-wide model axis spans two 8-card nodes: its groups cross a NIC
    assert row["coll_gbytes_dcn"] > 0 and row["n_collectives"] > 0
    assert row["t_collective_ms"] > 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_skip_rows_equal_reference(jdryrun, multi_pod):
    """Every cell the reference skips, the port skips with the same row,
    on both production meshes (full configs: a skip counts nothing)."""
    mesh = "pod2x16x16" if multi_pod else "pod16x16"
    skipped = 0
    for arch, cell, skip in shapes.cells(tconfigs.ARCHS):
        if skip is None:
            continue
        got = dryrun.run_cell(arch, cell.name, mesh=mesh)
        want = jdryrun.run_cell(arch, cell.name, multi_pod=multi_pod)
        assert got == want
        skipped += 1
    assert skipped == 9


# ---------------------------------------------------------------------------
# per-card counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_per_card_flops_times_positions_equal_one_card(kind):
    """On a data-only (4, 1) mesh each card counts a quarter of the
    one-card step's FLOPs, exactly (remat off: the sharded step's remat
    recomputes a superblock's last projection, torch's checkpoint does
    not)."""
    cfg = _olmo(remat=False)
    cell = shapes.ShapeCell("c", kind, 32, 8)
    one = dryrun._cell_metrics(cfg, cell)["flops"]
    per = [p["flops"] for p in dryrun._mesh_metrics(
        cfg, cell, _meta((4, 1)))["positions"]]
    assert len(set(per)) == 1 and per[0] * 4 == one


@pytest.mark.parametrize("n", [2, 4])
def test_dp_gradient_sum_is_a_ring_all_reduce(n):
    """On (n, 1) the only collective is the data-parallel sum of each
    leaf's bf16 gradient: 2 (n - 1) / n of the parameters' bf16 bytes
    a card, one all-reduce a leaf, inside a node."""
    cfg = _olmo()
    ps = leaves(step_lib.param_specs(cfg))
    nbytes = 2 * sum(t.numel() for t in ps)
    c = dryrun._mesh_metrics(cfg, shapes.ShapeCell("t", "train", 32, 8),
                             RowMesh(_meta((n, 1))))["positions"][0]["coll"]
    assert c.op_bytes == {"all-reduce": nbytes} and c.count == len(ps)
    assert c.wire_ici == 2 * (n - 1) / n * nbytes and c.wire_dcn == 0


@pytest.mark.parametrize("n", [2, 4])
def test_tp_prefill_collectives_match_hand_count(n):
    """A prefill at (1, n): the vocab-parallel embedding's all-reduce and
    two a layer (attention's and the MLP's row-parallel sums), each
    (b, s, d) f32, and the last position's logits all-gathered over the
    vocabulary."""
    cfg = _olmo()
    b, s, d, L, V = 8, 32, cfg.d_model, cfg.n_layers, cfg.vocab_size
    c = dryrun._mesh_metrics(cfg, shapes.ShapeCell("p", "prefill", s, b),
                             _meta((1, n)))["positions"][0]["coll"]
    reduce_b, gather_b = (2 * L + 1) * b * s * d * 4, b * (V // n) * 4
    assert c.op_bytes == {"all-reduce": reduce_b, "all-gather": gather_b}
    assert c.count == 2 * L + 2
    assert c.wire_ici == 2 * (n - 1) / n * reduce_b \
        + (n - 1) / n * b * V * 4


def test_groups_across_a_node_go_to_the_nic():
    """8 cards a node, positions numbered row-major: on (1, 16) the
    model groups span two nodes (all on the NIC), on (2, 8) they stay in
    one (all on NVLink; a prefill has no data-axis collective)."""
    cfg = _olmo()
    cell = shapes.ShapeCell("p", "prefill", 32, 8)
    wide = dryrun.largest(dryrun._mesh_metrics(
        cfg, cell, _meta((1, 16)))["positions"])["coll"]
    node = dryrun.largest(dryrun._mesh_metrics(
        cfg, cell, RowMesh(_meta((2, 8))))["positions"])["coll"]
    assert wide.wire_ici == 0 and wide.wire_dcn > 0
    assert node.wire_dcn == 0 and node.wire_ici > 0
    assert troofline.crosses_node(range(16)) and \
        not troofline.crosses_node(range(8, 16))


def test_flat_head_split_counts_per_card():
    """6 heads (2 KV heads) on (1, 4): ceil(6 / 4) = 2 heads a position,
    the last none; each position's decode FLOPs are its flat column
    blocks' projections, its KV heads' and its query heads' attention
    against the cache, exactly."""
    cfg = tconfigs.get_reduced("qwen2_7b").scaled(**_SIX_HEADS)
    b, cache, n = 8, 48, 4
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    per = dryrun._mesh_metrics(cfg, shapes.ShapeCell("d", "decode", cache, b),
                               _meta((1, n)))["positions"]
    heads = [(0, 2), (2, 4), (4, 6), (6, 6)]
    kv = [(0, 1), (0, 2), (1, 2), (2, 2)]
    for p, (lo, hi), (klo, khi) in zip(per, heads, kv):
        layer = (2 * b * d * (6 * hd // n) * 2            # wq, wo blocks
                 + 2 * (2 * b * d * (khi - klo) * hd)     # wk, wv cut
                 + 2 * (2 * b * (hi - lo) * cache * hd)   # scores, values
                 + 3 * 2 * b * d * (cfg.d_ff // n))       # swiglu
        want = L * layer + 2 * b * d * (cfg.vocab_size // n)
        assert p["flops"] == want, (lo, hi, p["flops"], want)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,over,shape,layout", [
    ("olmo_1b", {}, (2, 2, 2), "tp"),
    ("qwen2_7b", dict(fsdp=True), (2, 2), "tp"),
    ("qwen2_7b", {}, (1, 8), "tp"),
    ("qwen2_7b", _SIX_HEADS, (2, 4), "tp"),
    ("arctic_480b", dict(moe_dispatch="gspmd"), (2, 4), "tp"),
    ("arctic_480b", dict(moe_dispatch="shard_map"), (2, 2, 2), "tp"),
    ("kimi_k2_1t_a32b", dict(moe_dispatch="gspmd"), (2, 2, 2), "tp"),
    ("kimi_k2_1t_a32b", dict(moe_dispatch="shard_map"), (2, 4), "tp"),
    ("rwkv6_3b", dict(d_model=192), (2, 4), "tp"),
    ("olmo_1b", {}, (2, 2), "sp"),
    ("qwen2_7b", {}, (2, 2, 2), "sp"),
], ids=["olmo-2x2x2", "qwen2fsdp-2x2", "qwen2flat-1x8", "qwen2flat-2x4",
        "arcticgspmd-2x4", "arcticep-2x2x2", "kimigspmd-2x2x2", "kimiep-2x4",
        "rwkv6flat-2x4", "olmosp-2x2", "qwen2sp-2x2x2"])
def test_row_mesh_counts_equal_whole_mesh(arch, over, shape, layout, kind):
    """One data row's largest position: FLOPs, op bytes, memory and
    collectives equal the whole mesh's: the flat head splits (qwen2's
    query heads, rwkv6's time mix), both MoE dispatches (the GSPMD token
    gather over data, the shard_map expert-parallel capacity) and the
    sequence over ``model``."""
    cfg = tconfigs.get_reduced(arch).scaled(**over)
    cell = shapes.ShapeCell("r", kind, 32, 8)
    full = _meta(shape)
    whole = dryrun.largest(dryrun._mesh_metrics(
        cfg, cell, full, layout=layout)["positions"])
    row = dryrun.largest(dryrun._mesh_metrics(
        cfg, cell, RowMesh(full), layout=layout)["positions"])
    assert row["flops"] == whole["flops"] and row["bytes"] == whole["bytes"]
    assert row["memory"] == whole["memory"]
    assert vars(row["coll"]) == vars(whole["coll"])


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod16x16",
                                                         "pod2x16x16"])
@pytest.mark.parametrize("arch", ["qwen2_7b", "arctic_480b", "rwkv6_3b"])
def test_flat_split_steps_run_on_production_meshes(arch, multi_pod):
    """The configs whose heads 16-way TP does not divide (28, 56, 40):
    their train, prefill and decode steps at ``layout="tp"`` build and
    run on ``make_production_mesh()`` (meta, published widths, one
    layer, 32 tokens; one data row run), their heads split flat."""
    cfg = tconfigs.get(arch).scaled(n_layers=1)
    mesh = RowMesh(make_production_mesh(multi_pod=multi_pod))
    for kind in ("train", "prefill", "decode"):
        m = dryrun._mesh_metrics(cfg, shapes.ShapeCell("f", kind, 32, 32),
                                 mesh)
        top = dryrun.largest(m["positions"])
        assert top["flops"] > 0 and top["coll"].wire_dcn > 0, kind
    _, dec = step_lib.make_sharded_serving_steps(
        cfg, make_production_mesh(multi_pod=multi_pod), batch_size=32,
        seq_len=32)
    L = dec.specs.layout
    heads = cfg.d_model // cfg.rwkv_head_size if arch == "rwkv6_3b" \
        else cfg.n_heads
    assert L.flat and L.heads[0] == (0, -(-heads // 16))


def test_row_mesh_is_meta_only():
    with pytest.raises(ValueError, match="meta"):
        RowMesh(make_mesh((2, 2), ("data", "model"), "cpu"))
    r = RowMesh(_meta((2, 16, 16)))
    assert r.size == 16 and r.count(("pod", "data")) == 32
    assert r.groups("data") == [[i] for i in range(16)]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------
class _Log:
    def __init__(self):
        self.rows, self.depth = [], 0

    def quiet(self):
        log = self

        class Q:
            def __enter__(self):
                log.depth += 1

            def __exit__(self, *a):
                log.depth -= 1
        return Q()

    def record(self, kind, grp, ins, outs):
        self.rows.append((kind, grp.positions, [t.nbytes for t in ins],
                          [t.nbytes for t in outs]))


def test_recorder_sees_every_collective_and_its_adjoint():
    """On a (2, 2) CPU mesh: each group of a collective, forward and
    backward, with its whole-mesh positions and each member's bytes; the
    results as without a recorder; nothing recorded after it."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 4, generator=g, requires_grad=True)
          for _ in range(4)]
    log = _Log()
    with coll.recording(log):
        ys = coll.all_gather(xs, mesh, "model", 1)
        zs = coll.reduce_scatter(ys, mesh, "data", 0)
        ws = coll.all_reduce(zs, mesh, "model")
        mx = coll.all_reduce_max(ws, mesh, ("data", "model"))
        torch.autograd.grad(sum(w.sum() for w in ws), xs)
    want = coll.all_reduce(coll.reduce_scatter(coll.all_gather(
        xs, mesh, "model", 1), mesh, "data", 0), mesh, "model")
    assert all(torch.equal(a, b) for a, b in zip(ws, want))
    kinds = [(k, pos) for k, pos, _, _ in log.rows]
    assert kinds[:7] == [
        ("all-gather", (0, 1)), ("all-gather", (2, 3)),
        ("reduce-scatter", (0, 2)), ("reduce-scatter", (1, 3)),
        ("all-reduce", (0, 1)), ("all-reduce", (2, 3)),
        ("all-reduce", (0, 1, 2, 3))]
    # the backward, in the autograd engine's order: each adjoint per group
    assert sorted(kinds[7:]) == sorted([
        ("all-reduce", (0, 1)), ("all-reduce", (2, 3)),
        ("all-gather", (0, 2)), ("all-gather", (1, 3)),
        ("reduce-scatter", (0, 1)), ("reduce-scatter", (2, 3))])
    assert log.rows[0][2:] == ([32, 32], [64, 64])
    assert log.rows[2][2:] == ([64, 64], [32, 32])
    assert log.depth == 0 and coll._RECORDER is None
    n = len(log.rows)
    coll.all_reduce(xs, mesh, "model")
    assert len(log.rows) == n and mx[0].shape == (1, 8)


# ---------------------------------------------------------------------------
# the CLI and --multi-pod
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv,arch,mesh_shapes", [
    (["--mesh", "single"], "qwen2_7b", {"pod16x16": {"data": 16,
                                                     "model": 16}}),
    (["--mesh", "multi"], "qwen2_7b", {"pod2x16x16": {"pod": 2, "data": 16,
                                                      "model": 16}}),
    (["--mesh", "both"], "qwen2_7b", {"pod16x16": {"data": 16, "model": 16},
                                      "pod2x16x16": {"pod": 2, "data": 16,
                                                     "model": 16}}),
    (["--mesh", "single", "--dp", "32", "--tp", "8"], "qwen2_7b",
     {"pod16x16": {"data": 32, "model": 8}}),
    (["--mesh", "single", "--layout", "fsdp"], "qwen2_7b",
     {"pod16x16": {"data": 16, "model": 16}}),
    (["--mesh", "single", "--layout", "sp"], "qwen2_7b",
     {"pod16x16": {"data": 16, "model": 16}}),
    (["--mesh", "single", "--set-fsdp"], "olmo_1b",
     {"pod16x16": {"data": 16, "model": 16}}),
    (["--mesh", "single", "--moe-dispatch", "shard_map"], "kimi_k2_1t_a32b",
     {"pod16x16": {"data": 16, "model": 16}}),
    (["--mesh", "multi", "--cell-timeout", "600"], "qwen2_7b",
     {"pod2x16x16": {"pod": 2, "data": 16, "model": 16}}),
], ids=["single", "multi", "both", "dp32-tp8", "fsdp", "sp", "set-fsdp",
        "moe-dispatch", "cell-timeout"])
def test_cli_flags_write_rows(reduced, tmp_path, argv, arch, mesh_shapes):
    out = str(tmp_path)
    assert dryrun.main(["--arch", arch, "--shape", "decode_32k",
                        "--out", out] + argv) == 0
    for name, shape in mesh_shapes.items():
        with open(os.path.join(out, f"{arch}__decode_32k__{name}.json")) as f:
            row = json.load(f)
        assert row["status"] == "ok" and row["mesh"] == name
        assert row["mesh_shape"] == shape
        assert row["coll_gbytes_ici"] + row["coll_gbytes_dcn"] > 0
        # TP inside a node stays on NVLink; a 16-wide model axis does not
        nic = shape["model"] > troofline.HW.chips_per_pod
        assert (row["coll_gbytes_dcn"] > 0) == nic or "--layout" in argv
    assert sorted(os.listdir(out)) == sorted(
        f"{arch}__decode_32k__{name}.json" for name in mesh_shapes)


def test_cli_refusals_and_timeout(reduced, tmp_path):
    out = str(tmp_path)
    with pytest.raises(SystemExit, match="one card places nothing"):
        dryrun.main(["--arch", "olmo_1b", "--out", out, "--layout", "fsdp"])
    with pytest.raises(ValueError, match="one card places nothing"):
        dryrun.run_cell("olmo_1b", "decode_32k", mesh_shape=(4, 4))
    assert dryrun.main(["--arch", "qwen2_7b", "--shape", "train_4k",
                        "--mesh", "single", "--out", out,
                        "--cell-timeout", "0.05"]) == 1
    with open(os.path.join(out, "qwen2_7b__train_4k__pod16x16.json")) as f:
        row = json.load(f)
    assert row["status"] == "error" and "TimeoutError" in row["error"]


def test_multi_pod_mesh_from_args():
    """(pod 2, data 16, model 16) logical CPU shards; distinct cards it
    cannot see refused, naming both counts; never with --mesh."""
    m = mesh_from_args(None, "cpu", multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.size == 512 and m.device_type == "cpu"
    assert make_production_mesh(multi_pod=True, device="cpu").shape == m.shape
    if torch.cuda.device_count() < 512:
        with pytest.raises(ValueError, match=r"needs 512 cards, \d+ visible"):
            mesh_from_args(None, "cuda", multi_pod=True)
    with pytest.raises(SystemExit, match="one mesh"):
        mesh_from_args("2,2", "cpu", multi_pod=True)


def test_train_launcher_multi_pod_on_cpu(tmp_path):
    """``launch/train.py --multi-pod --device cpu``: one step of reduced
    olmo on the 512 logical shards (the batch of 2 replicated over the
    32 data shards), its loss and grad norm the one-device run's."""
    argv = ["--arch", "olmo_1b", "--device", "cpu", "--steps", "1",
            "--batch-size", "2", "--seq-len", "16", "--ckpt-every", "100"]
    pod = train_launch.main(argv + ["--multi-pod",
                                    "--workdir", str(tmp_path / "pod")])
    one = train_launch.main(argv + ["--workdir", str(tmp_path / "one")])
    assert pod["step"] == one["step"] == 1
    assert pod["loss"] == pytest.approx(one["loss"], rel=1e-5)
    assert pod["grad_norm"] == pytest.approx(one["grad_norm"], rel=1e-2)
