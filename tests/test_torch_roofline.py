"""The port's roofline analyzer (``repro_torch.analysis.roofline``)
against the reference's: HLO collective parsing on the same texts, the
report's terms and rows given the same hardware numbers, and the port's
own hardware, the H100."""
import dataclasses

import numpy as np
import pytest

from repro.analysis import roofline as jrf
from repro_torch.analysis import roofline as trf

HLO = """
HloModule test
ENTRY main {
  %p = f32[32,128]{1,0} parameter(0)
  %ag = f32[256,128]{1,0} all-gather(f32[32,128]{1,0} %p), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %ar = bf16[1024]{0} all-reduce(bf16[1024]{0} %x), replica_groups=[2,4]<=[8], to_apply=%add
  %rs = f32[16,128]{1,0} reduce-scatter(f32[128,128]{1,0} %y), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}, to_apply=%add
  %cp = f32[8,8]{1,0} collective-permute(f32[8,8]{1,0} %z), source_target_pairs={{0,1},{1,0}}
  %a2a = f32[64]{0} all-to-all(f32[64]{0} %w), replica_groups={{0,1,2,3}}, dimensions={0}
}
"""
DCN_EXPLICIT = ("%ar = f32[256]{0} all-reduce(f32[256]{0} %x), "
                "replica_groups={{0,256}}, to_apply=%add")
DCN_IOTA = ("%ar = f32[256]{0} all-reduce(f32[256]{0} %x), "
            "replica_groups=[256,2]<=[2,256]T(1,0), to_apply=%add")
ICI_IOTA = ("%ar = f32[256]{0} all-reduce(f32[256]{0} %x), "
            "replica_groups=[2,256]<=[512], to_apply=%add")
ASYNC = """
  %ag-start = f32[256,128]{1,0} all-gather-start(f32[32,128]{1,0} %p), replica_groups={{0,1,2,3,4,5,6,7}}
  %ag-done = f32[256,128]{1,0} all-gather-done(f32[256,128]{1,0} %ag-start)
"""
JHW = trf.HWSpec(**dataclasses.asdict(jrf.HW))   # the reference's numbers


def _stats(s):
    return (dict(s.op_bytes), s.wire_ici, s.wire_dcn, s.count)


# ---------------------------------------------------------------------------
# tests/test_roofline.py's six cases, on the port
# ---------------------------------------------------------------------------
def test_parse_collective_counts_and_bytes():
    s = trf.parse_collectives(HLO, chips_per_pod=256)
    assert s.count == 5
    want = 7 / 8 * 131072 + 2 * 3 / 4 * 2048 + 7 * 8192 + 256 + 3 / 4 * 256
    np.testing.assert_allclose(s.wire_ici, want)
    assert s.wire_dcn == 0.0
    assert s.op_bytes["all-gather"] == 32 * 128 * 4
    assert s.op_bytes["reduce-scatter"] == 128 * 128 * 4


def test_dcn_detection_explicit_groups():
    s = trf.parse_collectives(DCN_EXPLICIT, chips_per_pod=256)
    assert s.wire_dcn > 0 and s.wire_ici == 0


def test_dcn_detection_iota_groups():
    s = trf.parse_collectives(DCN_IOTA, chips_per_pod=256)
    assert s.wire_dcn > 0
    s2 = trf.parse_collectives(ICI_IOTA, chips_per_pod=256)
    assert s2.wire_dcn == 0 and s2.wire_ici > 0


def test_async_start_ops_counted_once():
    assert trf.parse_collectives(ASYNC).count == 1


def test_report_terms_and_bottleneck():
    """The reference's case, on the H100's own numbers."""
    hw = trf.HW
    rep = trf.RooflineReport(
        arch="x", shape="train_4k", mesh="h100x1", chips=1,
        hlo_flops=hw.peak_flops_bf16 * 0.1,
        hlo_bytes=hw.hbm_bw * 0.02,
        collectives=trf.CollectiveStats(wire_ici=hw.ici_bw * 0.01),
        model_flops=6e9 * 1e6)
    assert abs(rep.t_compute - 0.1) < 1e-9
    assert abs(rep.t_memory - 0.02) < 1e-9
    assert abs(rep.t_collective - 0.01) < 1e-9
    assert rep.bottleneck == "compute"
    row = rep.row()
    assert row["bottleneck"] == "compute"
    assert 0 < row["useful_ratio"]


def test_model_flops():
    assert trf.model_flops(1e9, 0, 1e6, "train") == 6e15
    assert trf.model_flops(1e9, 5e8, 1e6, "train") == 3e15
    assert trf.model_flops(1e9, 0, 128, "decode") == 2 * 1e9 * 128


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("text", [HLO, DCN_EXPLICIT, DCN_IOTA, ICI_IOTA,
                                  ASYNC])
@pytest.mark.parametrize("pod", [4, 8, 256])
def test_parse_collectives_equals_reference(text, pod):
    assert _stats(trf.parse_collectives(text, chips_per_pod=pod)) == \
        _stats(jrf.parse_collectives(text, chips_per_pod=pod))


@pytest.mark.parametrize("case", [
    dict(hlo_flops=197e12 * 0.1, hlo_bytes=819e9 * 0.02, chips=256,
         wire=(50e9 * 0.01, 0.0), model=6e9 * 1e6, memory=None),
    dict(hlo_flops=3e12, hlo_bytes=9e12, chips=1, wire=(0.0, 0.0),
         model=2e12, memory={"argument_size_in_bytes": 4e9,
                             "output_size_in_bytes": 1e9,
                             "temp_size_in_bytes": 2e9}),
    dict(hlo_flops=1e12, hlo_bytes=1e9, chips=512, wire=(3e9, 7e9),
         model=5e14, memory={"temp_size_in_bytes": 0}),
    dict(hlo_flops=0.0, hlo_bytes=0.0, chips=8, wire=(0.0, 0.0),
         model=0.0, memory=None)])
def test_report_row_equals_reference(case):
    """Given the reference's hardware numbers, every key of the row and
    its value equal the reference's."""
    def rep(mod, **hw):
        c = mod.CollectiveStats(op_bytes={"all-reduce": 5.0},
                                wire_ici=case["wire"][0],
                                wire_dcn=case["wire"][1], count=3)
        return mod.RooflineReport(
            arch="a", shape="s", mesh="m", chips=case["chips"],
            hlo_flops=case["hlo_flops"], hlo_bytes=case["hlo_bytes"],
            collectives=c, model_flops=case["model"],
            bytes_per_device=case["memory"], **hw)
    assert rep(trf, hw=JHW).row() == rep(jrf).row()


def test_analyze_equals_reference():
    kw = dict(arch="a", shape="s", mesh_name="m", chips=8,
              cost={"flops": 2e12, "bytes accessed": 3e10}, hlo_text=HLO,
              n_params=1e9, n_active=0, tokens=4096, kind="train",
              memory={"argument_size_in_bytes": 1e9})
    assert trf.analyze(**kw, hw=JHW).row() == jrf.analyze(**kw).row()


def test_hw_is_the_h100_at_700w():
    """No TPU number: the data sheet's H100 SXM5 80GB at 700 W."""
    hw = trf.HW
    assert hw.name == "h100-sxm5-80gb-700w"
    assert (hw.peak_flops_bf16, hw.hbm_bw, hw.hbm_bytes) == \
        (989e12, 3.35e12, 80e9)
    assert (hw.ici_bw, hw.dcn_bw, hw.chips_per_pod) == (450e9, 50e9, 8)
    rep = trf.RooflineReport(arch="a", shape="s", mesh="h100x1", chips=1,
                             hlo_flops=989e12, hlo_bytes=3.35e12)
    assert rep.hw is hw and rep.t_compute == 1.0 and rep.t_memory == 1.0
