"""The port's serving layer (``repro_torch.graph.service``) on the CPU,
held to the JAX package's.

The first part is the twin of ``tests/test_service.py``: the same
arrival-pattern soaks, bucket-ladder numerics (every delivered response
bit for bit equal to a replay of the packing served), lifecycle
invariants and robustness contract, on ``device="cpu"`` at ``native``
and at ``kernel`` (on CPU tensors the kernel wrappers run their plain
torch versions).  The reference's two sharded tests become the port's
``bucket_ladder(..., shards)`` arithmetic and a sharded service's ladder
(the sharded cases themselves are in ``tests/test_torch_mesh.py``).

The second part feeds the same seeded requests to the JAX
``PipelineService`` (``native``, and ``pallas`` in interpret mode, as
the JAX suite runs it on the CPU) and to the port's, drained with
``flush()``: every response within 2e-3 (the JAX suite's pipeline
tolerance, as rtol and atol), the same request/batch/padding counts,
and under one ``TINA_FAULTS`` spec and seed the same quarantined
requests and retry counts.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.registry import PIPELINES as JPIPELINES
from repro.core.registry import pipelines as jpipelines
from repro.obs import faults as jfaults
from repro_torch import graph
from repro_torch.core.registry import PIPELINES, pipelines
from repro_torch.graph import plan as plan_lib
from repro_torch.graph.errors import (DeadlineExceeded, InvalidRequest,
                                      Overloaded)
from repro_torch.graph.service import (PipelineService, bucket_ladder,
                                       replay_batches)
from repro_torch.obs import faults
from repro_torch.obs.faults import InjectedFault

jpipelines()
pipelines()
RNG = np.random.default_rng(23)
TOL = 2e-3          # the JAX suite's pipeline-vs-oracle tolerance

# per-test wall-clock ceiling (enforced where pytest-timeout is
# installed): a wedged batcher must fail fast, not hang
pytestmark = pytest.mark.timeout(120)

LOWERINGS = ["native", "kernel"]


def _signals(n_req, n=256):
    return [RNG.standard_normal(n).astype(np.float32) for _ in range(n_req)]


def _service(name="spectrogram", n=256, batch=8, **kw):
    kw.setdefault("batching", "continuous")
    kw.setdefault("record_batches", True)
    kw.setdefault("device", "cpu")
    return PIPELINES[name], PipelineService(
        PIPELINES[name].build(), signal_len=n, batch_size=batch, **kw)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# bucket ladder
# ---------------------------------------------------------------------------
def test_bucket_ladder_shapes():
    assert bucket_ladder(8) == (1, 2, 4, 8)
    assert bucket_ladder(1) == (1,)
    assert bucket_ladder(12) == (1, 2, 4, 8, 12)   # max is always a rung
    assert bucket_ladder(8, 2) == (2, 4, 8)        # shard-divisible only
    assert bucket_ladder(16, 4) == (4, 8, 16)
    with pytest.raises(ValueError, match="max_batch"):
        bucket_ladder(0)
    with pytest.raises(ValueError, match="shard count"):
        bucket_ladder(4, 8)


@pytest.mark.parametrize("max_batch,shards", [(8, 1), (12, 1), (8, 2),
                                              (16, 4), (6, 3), (1, 1)])
def test_bucket_ladder_matches_reference(max_batch, shards):
    from repro.graph.service import bucket_ladder as jladder
    assert bucket_ladder(max_batch, shards) == jladder(max_batch, shards)


def test_continuous_service_precompiles_ladder():
    _, svc = _service(batch=8)
    assert svc.buckets == (1, 2, 4, 8)
    assert set(svc.plans) == {1, 2, 4, 8}
    assert svc.plan is svc.plans[8]
    # bucket plans are ordinary cached plans: a direct compile of the
    # same shape is the same object (plan-cache reuse, no duplicates)
    g = svc.graph
    p = graph.compile(g, {g.inputs[0]: (4, 256)}, dtype="float32",
                      device="cpu")
    assert p is svc.plans[4]
    assert p.device.type == "cpu"
    svc.close()


def test_invalid_batching_mode_rejected():
    g = PIPELINES["spectrogram"].build()
    with pytest.raises(ValueError, match="batching="):
        PipelineService(g, signal_len=256, batch_size=2, batching="adaptive",
                        device="cpu")


# ---------------------------------------------------------------------------
# numerics: responses == replayed packing, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lowering", LOWERINGS)
def test_continuous_sync_flush_buckets_and_oracle(lowering):
    spec, svc = _service(batch=8, lowering=lowering)
    xs = _signals(13)
    futs = [svc.submit(x) for x in xs]
    assert svc.flush() == 2                     # 8 + 5->bucket(8)
    for x, f in zip(xs, futs):
        _close(f.result(timeout=5), spec.oracle(x))
    s = svc.stats()
    assert s["requests"] == 13 and s["batches"] == 2
    assert s["padded_slots"] == 3               # 5 rode an 8-bucket
    assert replay_batches(svc) == 13            # bitwise, exact packing
    svc.close()


@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("name", ["spectrogram", "pfb_power"])
def test_continuous_poisson_soak(name, lowering):
    """Poisson arrivals at partial load: every future resolves, every
    response is bit for bit the bucket plan's row for the packing that
    served it."""
    spec, svc = _service(name, batch=8, lowering=lowering)
    xs = _signals(48)
    gaps = np.random.default_rng(5).exponential(0.002, size=len(xs))
    with svc:
        futs = []
        for x, gap in zip(xs, gaps):
            time.sleep(gap)
            futs.append(svc.submit(x))
        outs = [f.result(timeout=60) for f in futs]       # all resolve
    for x, o in zip(xs, outs):
        _close(o, spec.oracle(x))
    assert replay_batches(svc) == len(xs)
    assert svc.stats()["batches"] >= 1
    total_slots = svc.stats()["requests"] + svc.stats()["padded_slots"]
    assert total_slots == sum(b for b, _ in svc.batch_log)


def test_continuous_bursty_arrivals():
    """Bursts larger than max_batch split into full batches; quiet gaps
    between bursts produce small buckets, not stalls."""
    spec, svc = _service(batch=4)
    xs = _signals(30)
    it = iter(xs)
    futs = []
    with svc:
        for burst in (9, 1, 12, 2, 6):          # > max, singleton, ...
            for _ in range(burst):
                futs.append(svc.submit(next(it)))
            time.sleep(0.05)                    # device drains the burst
        outs = [f.result(timeout=60) for f in futs]
    for x, o in zip(xs, outs):
        _close(o, spec.oracle(x))
    assert replay_batches(svc) == len(xs)
    assert all(b <= 4 for b, _ in svc.batch_log)
    assert any(len(items) == 4 for _, items in svc.batch_log)  # full loads


def test_continuous_adversarial_trickle_no_fill_wait():
    """An idle device dispatches a lone request immediately, whatever
    the fill deadline."""
    spec, svc = _service(batch=8, max_wait_ms=30_000.0)
    with svc:
        for x in _signals(3):
            t0 = time.perf_counter()
            out = svc.submit(x).result(timeout=10)
            assert time.perf_counter() - t0 < 10
            _close(out, spec.oracle(x))
    assert all(b == 1 for b, _ in svc.batch_log)   # served as singletons
    assert replay_batches(svc) == 3


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_continuous_concurrent_submitters(lowering):
    """Many producer threads racing submit(): nothing is lost and no
    submitter waits on another's result."""
    spec, svc = _service(batch=8, lowering=lowering)
    xs = _signals(40)
    results = [None] * len(xs)
    errs = []

    def producer(lo, hi):
        try:
            futs = [(i, svc.submit(xs[i])) for i in range(lo, hi)]
            for i, f in futs:
                results[i] = f.result(timeout=60)
        except Exception as e:                   # noqa: BLE001
            errs.append(e)

    with svc:
        threads = [threading.Thread(target=producer, args=(k, k + 8))
                   for k in range(0, 40, 8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
    assert not errs
    for x, o in zip(xs, results):
        _close(o, spec.oracle(x))
    assert replay_batches(svc) == len(xs)


# ---------------------------------------------------------------------------
# lifecycle invariants survive the continuous scheduler
# ---------------------------------------------------------------------------
def test_continuous_close_while_loaded_resolves_everything():
    spec, svc = _service(batch=4)
    xs = _signals(21)
    svc.start()
    futs = [svc.submit(x) for x in xs]
    svc.close()                                  # queue may still be deep
    for x, f in zip(xs, futs):
        _close(f.result(timeout=60), spec.oracle(x))
    assert replay_batches(svc) == len(xs)


def test_continuous_submit_and_start_after_close_raise():
    _, svc = _service(batch=2)
    with svc:
        svc.submit(np.zeros(256, np.float32)).result(timeout=60)
    with pytest.raises(RuntimeError, match="service closed"):
        svc.submit(np.zeros(256, np.float32))
    with pytest.raises(RuntimeError, match="service closed"):
        svc.start()
    svc.close()                                  # idempotent on success


def test_continuous_flush_while_started_raises():
    _, svc = _service(batch=2)
    svc.start()
    try:
        with pytest.raises(RuntimeError, match="two consumers"):
            svc.flush()
    finally:
        svc.close()
    assert svc.flush() == 0                      # legal again, and empty


def test_continuous_failed_batch_fails_futures_not_thread():
    spec, svc = _service(batch=4)
    boom = RuntimeError("bucket boom")
    svc.plans = {b: (lambda x, e=boom: (_ for _ in ()).throw(e))
                 for b in svc.buckets}
    with svc:
        f = svc.submit(np.zeros(256, np.float32))
        with pytest.raises(RuntimeError, match="bucket boom"):
            f.result(timeout=30)
        # the batcher thread survived the failed bucket
        svc.plans = {
            b: graph.compile(svc.graph, {svc.graph.inputs[0]: (b, 256)},
                             dtype="float32", device="cpu")
            for b in svc.buckets}
        x = _signals(1)[0]
        out = svc.submit(x).result(timeout=60)
    _close(out, spec.oracle(x))
    assert svc.stats()["failed_batches"] == 1
    # replay skips the failed packing and still verifies the healthy one
    assert replay_batches(svc) == 1


def test_fixed_mode_unchanged_stats_contract():
    """batching="fixed": one batch shape, the max_wait fill deadline,
    the reference's counter values and no continuous-only keys."""
    spec = PIPELINES["spectrogram"]
    svc = PipelineService(spec.build(), signal_len=256, batch_size=4,
                          batching="fixed", device="cpu")
    assert svc.buckets == (4,)
    xs = _signals(6)
    futs = [svc.submit(x) for x in xs]
    assert svc.flush() == 2
    for x, f in zip(xs, futs):
        _close(f.result(timeout=5), spec.oracle(x))
    s = svc.stats()
    assert {k: s[k] for k in ("requests", "batches", "padded_slots")} \
        == {"requests": 6, "batches": 2, "padded_slots": 2}
    assert "bucket_batches" not in s
    assert s["fill_ratio"] == 6 / 8
    svc.close()


# ---------------------------------------------------------------------------
# mesh: the ladder of a sharded service (the reference's two sharded tests)
# ---------------------------------------------------------------------------
def test_continuous_sharded_ladder_is_shard_divisible():
    """The sharded ladder is pure arithmetic: every rung splits over the
    shard count, as the reference's sharded service requires."""
    for shards in (1, 2, 4):
        ladder = bucket_ladder(4 * shards, shards)
        assert all(b % shards == 0 for b in ladder)
        assert ladder[0] == shards and ladder[-1] == 4 * shards


def test_sharded_service_is_not_yet_ported():
    """Ported: a sharded service starts its ladder at the shard count; a
    mesh asked of the card with no card raises, never falls back."""
    g = PIPELINES["spectrogram"].build()
    svc = PipelineService(g, signal_len=256, batch_size=4,
                          batching="continuous", mesh=2, device="cpu")
    assert svc.buckets == (2, 4) and svc.plan.mesh.size == 2
    svc.close()
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="0 available"):
            PipelineService(g, signal_len=256, batch_size=4, mesh=1)


def test_service_defaults_to_the_card():
    """No device: the plans run on "cuda" -- without a card that
    raises, it never falls back to the CPU."""
    g = PIPELINES["spectrogram"].build()
    if torch.cuda.is_available():
        svc = PipelineService(g, signal_len=256, batch_size=2)
        assert svc.plan.device.type == "cuda"
        svc.close()
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            PipelineService(g, signal_len=256, batch_size=2)


# ---------------------------------------------------------------------------
# robustness: admission, deadlines, validation, retry/bisect/degrade
# ---------------------------------------------------------------------------
@pytest.fixture
def chaos():
    """Deterministic fault config for one test; teardown disarms and
    forgets, so later tests re-read the ambient env."""
    yield faults.configure
    faults.reset()


def _poison(n=256):
    x = RNG.standard_normal(n).astype(np.float32)
    x[n // 3] = np.nan
    return x


def _outcome(f):
    e = f.exception(timeout=0)
    return ("err", e) if e is not None else ("ok", f.result(timeout=0))


def test_validate_strict_fails_poison_future_at_submit(chaos):
    spec, svc = _service(batch=2, validate="strict")
    bad = svc.submit(_poison())
    with pytest.raises(InvalidRequest, match="non-finite"):
        bad.result(timeout=0)                  # failed without any batch
    x = _signals(1)[0]
    good = svc.submit(x)
    assert svc.flush() == 1
    _close(good.result(timeout=5), spec.oracle(x))
    s = svc.stats()
    assert s["invalid"] == 1 and s["requests"] == 1    # never admitted
    svc.close()


def test_invalid_robustness_knobs_rejected():
    g = PIPELINES["spectrogram"].build()
    for kw in ({"on_full": "drop"}, {"validate": "maybe"},
               {"queue_limit": 0}, {"deadline_ms": -1},
               {"max_retries": -1}):
        with pytest.raises(ValueError):
            PipelineService(g, signal_len=256, batch_size=2, device="cpu",
                            **kw)


def test_queue_limit_shed_delivers_overloaded(chaos):
    spec, svc = _service(batch=4, queue_limit=2, on_full="shed")
    xs = _signals(5)
    futs = [svc.submit(x) for x in xs]         # no consumer yet: 2 admit,
    for f in futs[2:]:                         # 3 shed instantly
        with pytest.raises(Overloaded, match="queue full"):
            f.result(timeout=0)
    assert svc.flush() == 1
    for x, f in zip(xs[:2], futs[:2]):
        _close(f.result(timeout=5), spec.oracle(x))
    s = svc.stats()
    assert s["shed"] == 3 and s["requests"] == 2       # shed != admitted
    svc.close()


def test_queue_limit_raise_policy(chaos):
    _, svc = _service(batch=4, queue_limit=1, on_full="raise")
    svc.submit(_signals(1)[0])
    with pytest.raises(Overloaded):
        svc.submit(_signals(1)[0])
    assert svc.stats()["shed"] == 1
    svc.flush()
    svc.close()


def test_queue_limit_block_admits_when_space_frees(chaos):
    spec, svc = _service(batch=1, queue_limit=1, on_full="block")
    x0, x1 = _signals(2)
    f0 = svc.submit(x0)
    box = {}

    def blocked_submit():
        box["fut"] = svc.submit(x1)            # blocks until f0 drains

    t = threading.Thread(target=blocked_submit)
    t.start()
    time.sleep(0.05)
    assert t.is_alive()                        # genuinely blocked, not shed
    deadline = time.perf_counter() + 30
    while t.is_alive() and time.perf_counter() < deadline:
        svc.flush()                            # drain -> space -> admit
        time.sleep(0.005)
    t.join(timeout=30)
    assert not t.is_alive()
    svc.flush()
    _close(f0.result(timeout=5), spec.oracle(x0))
    _close(box["fut"].result(timeout=5), spec.oracle(x1))
    assert svc.stats()["shed"] == 0
    svc.close()


def test_blocked_submit_honors_deadline(chaos):
    _, svc = _service(batch=1, queue_limit=1, on_full="block")
    svc.submit(_signals(1)[0])                 # fills the queue; no consumer
    t0 = time.perf_counter()
    f = svc.submit(_signals(1)[0], deadline_ms=50)
    assert time.perf_counter() - t0 < 10       # gave up at the deadline
    with pytest.raises(DeadlineExceeded):
        f.result(timeout=0)
    assert svc.stats()["expired"] == 1
    svc.flush()
    svc.close()


def test_close_wakes_blocked_submitter(chaos):
    _, svc = _service(batch=1, queue_limit=1, on_full="block")
    f0 = svc.submit(_signals(1)[0])
    errs = []

    def blocked_submit():
        try:
            svc.submit(_signals(1)[0])
        except RuntimeError as e:
            errs.append(e)

    t = threading.Thread(target=blocked_submit)
    t.start()
    time.sleep(0.05)
    svc.close()                                # wakes + rejects the waiter,
    t.join(timeout=30)                         # drains the admitted request
    assert not t.is_alive()
    assert len(errs) == 1 and "service closed" in str(errs[0])
    assert f0.result(timeout=5) is not None


def test_deadline_expiry_soak_no_device_slots(chaos):
    _, svc = _service(batch=8)
    futs = [svc.submit(x, deadline_ms=0) for x in _signals(50)]
    time.sleep(0.001)
    assert svc.flush() == 0                    # swept, nothing dispatched
    for f in futs:
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=0)
    s = svc.stats()
    assert s["expired"] == 50 and s["batches"] == 0
    assert svc.batch_log == []                 # zero device dispatches
    svc.close()


def test_mixed_deadlines_only_expired_fail(chaos):
    spec, svc = _service(batch=8, deadline_ms=0)   # service-wide default
    x_live = _signals(1)[0]
    doomed = [svc.submit(x) for x in _signals(3)]
    live = svc.submit(x_live, deadline_ms=10_000)  # per-request override
    time.sleep(0.001)
    assert svc.flush() == 1
    for f in doomed:
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=0)
    _close(live.result(timeout=5), spec.oracle(x_live))
    assert svc.stats()["expired"] == 3
    svc.close()


def test_transient_fault_retried_to_success(chaos):
    chaos("device_run:once", seed=0)
    spec, svc = _service(batch=2, retry_backoff_ms=0.1)
    x = _signals(1)[0]
    f = svc.submit(x)
    assert svc.flush() == 1
    _close(f.result(timeout=5), spec.oracle(x))
    s = svc.stats()
    assert s["retries"] == 1 and s["failed_batches"] == 0
    assert s["quarantined"] == 0
    assert replay_batches(svc) == 1
    svc.close()


def test_persistent_fault_skips_retries_and_quarantines(chaos):
    chaos("device_run:nan", seed=0)
    _, svc = _service(batch=2)
    f = svc.submit(_poison())
    assert svc.flush() == 1
    with pytest.raises(InjectedFault):
        f.result(timeout=0)
    s = svc.stats()
    assert s["retries"] == 0                   # pointless retries skipped
    assert s["failed_batches"] == 1 and s["quarantined"] == 1
    svc.close()


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_bisect_isolates_poison_rows_healthy_rows_served(chaos, lowering):
    """One batch, two poison rows: the six healthy futures get results
    (replay-verified), only the poisoned futures get the error."""
    chaos("device_run:nan", seed=0)
    spec, svc = _service(batch=8, lowering=lowering)
    xs = _signals(8)
    poison_idx = {2, 5}
    for i in poison_idx:
        xs[i] = _poison()
    futs = [svc.submit(x) for x in xs]
    svc.flush()
    for i, (x, f) in enumerate(zip(xs, futs)):
        if i in poison_idx:
            with pytest.raises(InjectedFault):
                f.result(timeout=0)
        else:
            _close(f.result(timeout=0), spec.oracle(x))
    s = svc.stats()
    assert s["quarantined"] == 2 and s["failed_batches"] == 1
    assert replay_batches(svc) == 6
    assert all(not any(np.isnan(x).any() for x, _ in items)
               for _, items in svc.batch_log)
    svc.close()


def test_runtime_degradation_to_reference_lowering(chaos):
    """A bucket whose kernel plan keeps failing is recompiled once with
    the reference lowering on the tenant's own device (the @tag spec
    stops matching after the retag), recorded on downgrades, and then
    serves requests."""
    chaos("device_run@kernel:always", seed=0)
    spec, svc = _service(batch=1, lowering="kernel", max_retries=0,
                         degrade_after=2)
    x1, x2, x3 = _signals(3)
    f1 = svc.submit(x1)
    svc.flush()
    with pytest.raises(InjectedFault):         # first strike: quarantined
        f1.result(timeout=0)
    assert svc.downgrades == {}
    f2 = svc.submit(x2)
    with pytest.warns(UserWarning, match="reference lowering"):
        svc.flush()                            # second strike: degrade,
    _close(f2.result(timeout=0), spec.oracle(x2))   # same batch served
    assert svc.downgrades == {1: "kernel"}
    degraded = svc.plans[1]
    assert degraded.device.type == "cpu"       # kept the tenant's device
    assert set(degraded.lowerings.values()) == {"native"}
    f3 = svc.submit(x3)                        # steady state: degraded plan
    svc.flush()
    _close(f3.result(timeout=0), spec.oracle(x3))
    s = svc.stats()
    assert s["degraded"] == 1 and s["quarantined"] == 1
    assert replay_batches(svc) == 2            # the two healthy dispatches
    svc.close()


def test_close_under_failure_resolves_everything(chaos):
    """close() while batches are retrying/bisecting resolves every
    pending future, leaves no live thread, and stays retryable."""
    chaos("device_run:0.5,device_run:nan", seed=3)
    _, svc = _service(batch=4, retry_backoff_ms=0.1)
    xs = _signals(30)
    for i in range(0, 30, 6):
        xs[i] = _poison()
    svc.start()
    futs = [svc.submit(x) for x in xs]
    svc.close()                                # mid-chaos shutdown
    assert svc._thread is None                 # batcher actually exited
    for i, f in enumerate(futs):
        kind, val = _outcome(f)                # every future resolved
        if kind == "err":
            assert isinstance(val, InjectedFault)
        if i % 6 == 0:
            assert kind == "err"               # poison never yields a row
    svc.close()                                # retryable/idempotent
    with pytest.raises(RuntimeError, match="service closed"):
        svc.submit(xs[1])


def test_acceptance_soak_faults_poison_overload(chaos):
    """>= 5% device_run failure rate, mixed poison payloads, offered
    load > capacity with shedding: every future resolves with a result
    or a typed exception, healthy rows replay bit for bit, and the
    batcher survives."""
    chaos("device_run:0.05,device_run:nan", seed=7)
    spec, svc = _service(batch=8, queue_limit=8, on_full="shed",
                         retry_backoff_ms=0.1)
    xs = _signals(40)
    for i in range(0, 40, 10):
        xs[i] = _poison()
    futs = [svc.submit(x) for x in xs]         # burst, no consumer
    assert svc.stats()["shed"] == 32
    svc.start()                                # sustained load
    xs2 = _signals(80)
    for i in range(0, 80, 10):
        xs2[i] = _poison()
    futs2 = [svc.submit(x, deadline_ms=30_000) for x in xs2]
    expired = [svc.submit(x, deadline_ms=0) for x in _signals(5)]
    svc.close()
    assert svc._thread is None                 # the batcher never died
    for f in futs + futs2 + expired:
        kind, val = _outcome(f)                # EVERY future resolved
        if kind == "err":
            assert isinstance(val, (InjectedFault, Overloaded,
                                    DeadlineExceeded))
    for f in expired:
        assert isinstance(f.exception(timeout=0),
                          (DeadlineExceeded, Overloaded))
    for (i, f), x in zip(enumerate(futs2), xs2):
        kind, val = _outcome(f)
        if i % 10 == 0:
            assert kind == "err"               # poison never yields a row
        elif kind == "ok":
            _close(val, spec.oracle(x))
    s = svc.stats()
    assert s["quarantined"] >= 1 and s["shed"] >= 32
    assert replay_batches(svc) >= 1            # healthy packings bit-exact
    assert faults.stats()["device_run"] >= 1


# ---------------------------------------------------------------------------
# a delivered result owns its memory; service plans are the offline ones
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("overlap", [False, True], ids=["blocking",
                                                        "overlap"])
def test_delivered_result_unchanged_by_later_batches(overlap):
    spec, svc = _service("pfb_power", n=512, batch=4, overlap=overlap)
    xs = _signals(12, 512)
    with svc:
        first = svc.submit(xs[0]).result(timeout=60)
        kept = first.copy()
        outs = [f.result(timeout=60) for f in
                [svc.submit(x) for x in xs[1:]]]
    np.testing.assert_array_equal(first, kept)
    _close(first, spec.oracle(xs[0]))
    for x, o in zip(xs[1:], outs):
        _close(o, spec.oracle(x))
    # no two delivered batches share host memory
    bases = {id(o.base if o.base is not None else o) for o in [first, *outs]}
    assert len(bases) == svc.stats()["batches"]


@pytest.mark.parametrize("overlap", [False, True], ids=["blocking",
                                                        "overlap"])
def test_service_plans_are_the_offline_cache_entries(overlap):
    """Overlapped or not, a service's bucket plans are the plan cache's
    entries for its options: an offline compile with the same options
    returns the same objects, consts and packs."""
    spec, svc = _service("fir_decimate", n=512, batch=4, overlap=overlap)
    g = svc.graph
    for b, plan in svc.plans.items():
        assert graph.compile(g, {g.inputs[0]: (b, 512)},
                             device="cpu") is plan
    svc.close()


def test_state_made_once_off_the_card_has_no_event():
    """``made_once`` caches like ``lru_cache`` and hands back the value
    itself; off the card a :class:`Made` records no event."""
    import repro_torch
    calls = []

    @repro_torch.made_once(4)
    def make(n):
        calls.append(n)
        return torch.arange(n)

    a = make(3)
    assert make(3) is a and calls == [3]
    make.cache_clear()
    assert make(3) is not a and calls == [3, 3]
    m = repro_torch.Made((a, torch.zeros(2)))
    assert m._event is None and m.get()[0] is a


# ---------------------------------------------------------------------------
# against the JAX package's service
# ---------------------------------------------------------------------------
JAX_LOWERING = {"native": "native", "kernel": "pallas"}


def _pair(name, n, batch, lowering, **kw):
    """The JAX service and the port's for one pipeline, same knobs."""
    from repro.graph.plan import CompileOptions as JOptions
    from repro.graph.service import PipelineService as JService
    jsvc = JService(JPIPELINES[name].build(), signal_len=n,
                    batch_size=batch,
                    options=JOptions(lowering=JAX_LOWERING[lowering]),
                    record_batches=True, **kw)
    psvc = PipelineService(PIPELINES[name].build(), signal_len=n,
                           batch_size=batch, lowering=lowering,
                           device="cpu", record_batches=True, **kw)
    return jsvc, psvc


COUNTS = ("requests", "batches", "padded_slots", "bucket_batches")


@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("name,n", [("spectrogram", 256),
                                    ("pfb_power", 512),
                                    ("fir_decimate", 300)])
def test_responses_match_jax_service(name, n, lowering):
    jsvc, psvc = _pair(name, n, 4, lowering, batching="continuous")
    rng = np.random.default_rng(hash((name, n)) % 2 ** 32)
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(11)]
    jf = [jsvc.submit(x) for x in xs]
    pf = [psvc.submit(x) for x in xs]
    assert jsvc.flush() == psvc.flush() == 3     # 4 + 4 + 3->bucket(4)
    for a, b in zip(jf, pf):
        want = np.asarray(a.result(timeout=60))
        got = b.result(timeout=60)
        assert got.shape == want.shape and got.dtype == want.dtype
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)
    js, ps = jsvc.stats(), psvc.stats()
    assert {k: js[k] for k in COUNTS} == {k: ps[k] for k in COUNTS}
    assert replay_batches(psvc) == len(xs)
    jsvc.close()
    psvc.close()


@pytest.mark.parametrize("batching", ["fixed", "continuous"])
def test_fault_outcomes_match_jax_service(batching):
    """One TINA_FAULTS spec and seed armed in both packages: the same
    requests are quarantined, the same retries counted, and the healthy
    rows agree."""
    spec = "device_run:0.3,device_run:nan"
    jsvc, psvc = _pair("spectrogram", 256, 4, "native", batching=batching,
                       retry_backoff_ms=0.0)
    xs = _signals(22)
    for i in (1, 9, 14):
        xs[i] = _poison()
    try:
        jfaults.configure(spec, seed=11)
        jf = [jsvc.submit(x) for x in xs]
        jsvc.flush()
        faults.configure(spec, seed=11)
        pf = [psvc.submit(x) for x in xs]
        psvc.flush()
    finally:
        jfaults.reset()
        faults.reset()
    jo = [_outcome(f) for f in jf]
    po = [_outcome(f) for f in pf]
    assert [k for k, _ in jo] == [k for k, _ in po]
    for (jk, jv), (_, pv) in zip(jo, po):
        if jk == "ok":
            np.testing.assert_allclose(pv, np.asarray(jv), rtol=TOL,
                                       atol=TOL * np.abs(jv).max())
        else:
            assert type(jv).__name__ == type(pv).__name__
    keys = ("retries", "quarantined", "failed_batches", "degraded",
            "batches", "requests")
    js, ps = jsvc.stats(), psvc.stats()
    assert {k: js[k] for k in keys} == {k: ps[k] for k in keys}
    assert ps["quarantined"] >= 3
    jsvc.close()
    psvc.close()


def test_plan_cache_key_matches_options():
    """A service's bucket plans are the plan cache's: the options that
    built them (and only those) find them again."""
    _, svc = _service(batch=2, lowering="kernel")
    g = svc.graph
    again = plan_lib.compile(g, {g.inputs[0]: (2, 256)},
                             options=svc._default.options)
    assert again is svc.plans[2]
    svc.close()
