"""The counts at a hand-worked shape, and at the kernel table's pfb full
row (PERF.md §6: 0.294 ms, bound by operations at 513 columns)."""
import pytest

from counts import Work, peaks
from counts import pfb_power as c


def test_pfb_by_hand():
    # rows 1, n 64, P 16, M 2: T = 64 / 16 - 2 + 1 = 3 frames
    w = c.pfb(1, 64, 16, 2)
    assert w.bytes == 64 * 4 + 2 * 16 * 4 + 3 * 16 * 8
    assert dict(w.ops) == {"fp32": 2 * 2 * 16 * 3, "tf32": 4 * 16 * 9 * 3}
    assert w.seconds() == pytest.approx(
        max(w.bytes / 3.35e12, 192 / 67e12 + 1728 / 495e12))


def test_chain_and_pipeline_by_hand():
    ch = c.chain(1, 64, 16, 2)
    assert ch.bytes == 3 * 16 * (8 + 4)
    assert dict(ch.ops) == {"fp32": 3 * 3 * 16}
    pipe = c.pipeline(1, 64, 16, 2)
    assert pipe.bytes == 64 * 4 + 2 * 16 * 4 + 3 * 16 * 4
    assert dict(pipe.ops) == {"fp32": 192 + 144, "tf32": 1728}
    # a fusion of both nodes never needs more than the two apart
    assert pipe.seconds() <= c.pfb(1, 64, 16, 2).seconds() + ch.seconds()


def test_kernel_table_row():
    w = c.pfb(16, 2 ** 22, 1024, 8)
    assert w.seconds() * 1e3 == pytest.approx(0.294, abs=5e-4)
    assert w.seconds() > w.bytes / peaks.HBM_BYTES_PER_S     # ops-bound


def test_work_adds_by_pipe():
    a = Work(10.0, (("fp32", 1.0),))
    b = Work(5.0, (("fp32", 2.0), ("tf32", 3.0)))
    assert (a + b) == Work(15.0, (("fp32", 3.0), ("tf32", 3.0)))
