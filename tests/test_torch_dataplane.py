"""The port's switch dataplane (repro_torch.switchsim, repro_torch.core.switch)
against the JAX reference's, the counterpart of tests/test_switchsim.py,
tests/test_multitenant.py and tests/test_switch.py.

Every case feeds the same numpy inputs, made from a seed, to the port's
``BatchedDataplane`` (its torch slot machine, here on the CPU), the port's
``NumpyDataplane`` and per-packet ``FpisaSwitch``, and the reference's
``BatchedDataplane`` / ``NumpyDataplane`` / ``FpisaSwitch``, under the
reference cases' drop probabilities and seeds. All must give the same
result bits (integer views), the same ``stats`` and ``job_stats``, and the
same completion rounds:

* both add variants, P = 1 and 3 pipelines, lossless and lossy fabrics, a
  worker failure, and fp32, fp16 and bf16 payloads on the batched path;
* J = 1 and 2 tenants with disjoint and overlapping quotas, J = 3 under
  contention; fresh-foreign denial, takeover against preemption, per-job
  reclaim, rank-overflow deferral order, Jain fairness, the registry;
* the rank table holds each packet in at most one cell, so the per-round
  index writes never collide; the round loop runs under deterministic
  algorithms; without a card the dataplane raises.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import switchsim as jsw  # noqa: E402
from repro.core import switch as jswitch  # noqa: E402
from repro.switchsim import dataplane as jdp  # noqa: E402
from repro_torch import switchsim as tsw  # noqa: E402
from repro_torch.core import switch as tswitch  # noqa: E402
from repro_torch.switchsim import dataplane as tdp  # noqa: E402

CPU = "cpu"


def _vec(w, n, seed, scale=0.01, wide=False):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((w, n)) * scale
    if wide:
        v = v * np.exp2(rng.integers(-12, 12, (w, n)))
    return v.astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _legs(kw):
    """(the reference's batched dataplane, [(name, port dataplane), ...]) on
    one config: the port's batched dataplane on the CPU and, for fp32, its
    numpy mirror."""
    port = [("torch", tsw.BatchedDataplane(tsw.DataplaneConfig(**kw), device=CPU))]
    if kw.get("fmt_name", "fp32") == "fp32":
        port.append(("numpy", tsw.NumpyDataplane(tsw.DataplaneConfig(**kw))))
    return jsw.BatchedDataplane(jsw.DataplaneConfig(**kw)), port


# The reference's property sweep: 4 workers, 1024 elements, packets of 64
# over 2 slots per pipeline. Several tests run on its configurations, so the
# reference's jit compiles each of them once for the file.
def _sweep_kw(variant, pipelines):
    return dict(num_workers=4, num_slots=2, elems_per_packet=64, num_pipelines=pipelines,
                variant=variant)


def _sweep_vec(pipelines):
    return _vec(4, 1024, seed=pipelines, wide=True)


@functools.lru_cache(maxsize=None)
def _sweep_reference(variant, pipelines, drop, seed):
    """The reference's run of one sweep case, computed once for the file:
    (result, arrival order, stats, last_now)."""
    ref = jsw.BatchedDataplane(jsw.DataplaneConfig(**_sweep_kw(variant, pipelines)))
    want, arrivals = jsw.run_aggregation(ref, _sweep_vec(pipelines), drop_prob=drop,
                                         seed=seed, record_arrivals=True)
    return want, arrivals, ref.stats, ref.last_now


# ---------------------------------------------------------------------------
# shared constants, slot mapping, lottery, the rank table
# ---------------------------------------------------------------------------


def test_shared_constants_equal_the_reference():
    assert tsw.COUNTERS == jsw.COUNTERS
    assert tsw.SLOT_STATE_FIELDS == jsw.SLOT_STATE_FIELDS
    assert tsw.DataplaneState._fields == jsw.DataplaneState._fields
    names = {"BatchedDataplane", "DataplaneConfig", "DataplaneState", "NumpyDataplane",
             "ingest_batch", "init_state", "lottery_pref", "reclaim_dead_worker",
             "run_aggregation", "slot_of", "slot_of_tenant", "jain_fairness",
             "reset_shared_dataplanes", "run_multitenant", "shared_dataplane",
             "shared_emulated_allreduce"}
    assert all(hasattr(tsw, n) for n in names)


@pytest.mark.parametrize("kw", [
    dict(num_workers=4, num_slots=8, num_pipelines=2),
    dict(num_workers=4, num_slots=8, num_pipelines=2, num_jobs=2, job_slots=(4, 4),
         job_workers=(4, 4)),
    dict(num_workers=5, num_slots=6, num_pipelines=3, num_jobs=3, job_slots=(2, 6, 3),
         job_workers=(2, 1, 5), job_weights=(6, 3, 1), job_priorities=(0, 2, 1),
         rounds_per_call=3, stale_after=2),
], ids=["J1", "J2-disjoint", "J3-overlap"])
def test_config_slot_mapping_and_lottery_equal_the_reference(kw):
    jc, tc = jsw.DataplaneConfig(**kw), tsw.DataplaneConfig(**kw)
    for prop in ("quotas", "priorities", "weights", "ports", "job_bases", "rounds",
                 "window", "total_slots", "physical_slots_per_pipeline"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert [tc.job_window(j) for j in range(tc.num_jobs)] == \
        [jc.job_window(j) for j in range(jc.num_jobs)]
    rng = np.random.default_rng(5)
    jobs = rng.integers(0, tc.num_jobs, 600)
    chunks = rng.integers(0, 5000, 600)
    want = jsw.slot_of_tenant(jc, jobs, chunks)
    np.testing.assert_array_equal(tsw.slot_of_tenant(tc, jobs, chunks), want)
    np.testing.assert_array_equal(
        tsw.slot_of_tenant(tc, torch.from_numpy(jobs), torch.from_numpy(chunks),
                           torch).numpy(), want)
    for now in (0, 1, 17, 65520, 65521, 10**6):
        want = np.asarray(jsw.lottery_pref(jc, now, jnp))
        np.testing.assert_array_equal(tsw.lottery_pref(tc, now, np), want)
        np.testing.assert_array_equal(tsw.lottery_pref(tc, now, torch, CPU).numpy(), want)


@pytest.mark.parametrize("rounds", [1, 2, 8])
def test_rank_table_equals_reference_and_cells_are_unique(rounds):
    """Each packet index sits in at most one cell of the table, so a round's
    index writes of ready / results / accepted never collide (only the
    spare row takes several)."""
    rng = np.random.default_rng(rounds)
    keys = rng.integers(0, 12, 300).astype(np.int32)
    valid = rng.random(300) > 0.2
    jt, jd = jdp._rank_table(jnp.asarray(keys), jnp.asarray(valid), 12, rounds)
    tt, td = tdp._rank_table(torch.from_numpy(keys).long(), torch.from_numpy(valid), 12,
                             rounds)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    cells = tt.numpy()[tt.numpy() >= 0]
    assert len(np.unique(cells)) == len(cells)
    for col in tt.numpy().T:  # one packet per slot per round, each of its own slot
        live = col[col >= 0]
        assert len(np.unique(keys[live])) == len(live)
    assert (tt.numpy() >= 0).sum() + td.numpy().sum() == valid.sum()


# ---------------------------------------------------------------------------
# single tenant: batched == numpy == per-packet == reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["fpisa_a", "full"])
@pytest.mark.parametrize("pipelines", [1, 3])
@pytest.mark.parametrize("drop,seed", [(0.0, 0), (0.3, 7), (0.7, 13)])
def test_run_aggregation_equals_reference(variant, pipelines, drop, seed):
    """The reference's property sweep, both variants; bits, stats, and the
    arrival order (exactly-once under loss)."""
    kw = _sweep_kw(variant, pipelines)
    want, want_arr, want_stats, want_now = _sweep_reference(variant, pipelines, drop, seed)
    assert want_stats["packets"] == 4 * 16
    for name, dp in _legs(kw)[1]:
        got, arr = tsw.run_aggregation(dp, _sweep_vec(pipelines), drop_prob=drop, seed=seed,
                                       record_arrivals=True)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
        assert dp.stats == want_stats, name
        assert arr == want_arr, name
        assert dp.last_now == want_now
    if drop >= 0.3:
        assert want_stats["duplicates"] > 0


@pytest.mark.parametrize("fmt", ["fp32", "fp16", "bf16"])
def test_batched_formats_equal_reference(fmt):
    """fp16 and bf16 payloads (staged through the format's packed dtype, as
    the reference stages them), with +-inf and NaN in the stream."""
    vec = _vec(4, 1000, seed=3, scale=3.0)
    vec[0, 5], vec[1, 7], vec[2, 300] = np.nan, np.inf, -np.nan
    kw = dict(_sweep_kw("full", 3), fmt_name=fmt)
    ref, legs = _legs(kw)
    want = jsw.run_aggregation(ref, vec, drop_prob=0.2, seed=1)
    for name, dp in legs:
        got = tsw.run_aggregation(dp, vec, drop_prob=0.2, seed=1)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
        assert dp.stats == ref.stats


@pytest.mark.parametrize("variant", ["fpisa_a", "full"])
def test_worker_failure_equals_reference(variant):
    vec = _vec(4, 3000, seed=2, wide=True)
    ref, legs = _legs(_sweep_kw(variant, 3))
    fabric = dict(drop_prob=0.1, seed=5, fail_worker=2, fail_round=3)
    want = jsw.run_aggregation(ref, vec, **fabric)
    assert ref.stats["reclaimed"] > 0
    for name, dp in legs:
        got = tsw.run_aggregation(dp, vec, **fabric)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
        assert dp.stats == ref.stats, name


@pytest.mark.parametrize("drop,seed", [(0.0, 0), (0.15, 3), (0.5, 11)])
def test_per_packet_switch_equals_batched_and_reference(drop, seed):
    """The per-packet FpisaSwitch through the batched driver (the
    reference's test_batched_matches_perpacket_bit_exact)."""
    vec = _vec(4, 1024, seed=seed)
    kw = dict(num_workers=4, num_slots=4, elems_per_packet=64)
    legacy = tswitch.FpisaSwitch(tswitch.SwitchConfig(**kw), device=CPU)
    batched = tsw.BatchedDataplane(tsw.DataplaneConfig(**kw), device=CPU)
    ref = jswitch.FpisaSwitch(jswitch.SwitchConfig(**kw))
    want = jsw.run_aggregation(ref, vec, drop_prob=drop, seed=seed)
    for dp in (legacy, batched):
        got = tsw.run_aggregation(dp, vec, drop_prob=drop, seed=seed)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert legacy.stats == ref.stats
    assert {k: batched.stats[k] for k in tsw.COUNTERS} == ref.stats
    assert legacy.job_stats == ref.job_stats


@pytest.mark.parametrize("drop,variant", [(0.0, "fpisa_a"), (0.4, "fpisa_a"), (0.2, "full")])
def test_legacy_immediate_eligibility_driver_equals_reference(drop, variant):
    vec = _vec(8, 1000, seed=7)
    kw = dict(num_workers=8, num_slots=4, elems_per_packet=64, variant=variant)
    mine = tswitch.FpisaSwitch(tswitch.SwitchConfig(**kw), device=CPU)
    ref = jswitch.FpisaSwitch(jswitch.SwitchConfig(**kw))
    got = tswitch.run_aggregation(mine, vec, drop_prob=drop, seed=3)
    want = jswitch.run_aggregation(ref, vec, drop_prob=drop, seed=3)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert mine.stats == ref.stats
    assert mine.stats["packets"] == 8 * 16


def test_stale_counter_separate_from_duplicates():
    """The reference's packet sequence, packet by packet in lockstep: a
    retransmission for a recycled slot is stale, a true duplicate re-serves
    the cached result."""
    e = 8
    mine = tswitch.FpisaSwitch(tswitch.SwitchConfig(num_workers=2, num_slots=1,
                                                    elems_per_packet=e), device=CPU)
    ref = jswitch.FpisaSwitch(jswitch.SwitchConfig(num_workers=2, num_slots=1,
                                                   elems_per_packet=e))
    pay = np.ones(e, np.float32)
    for w, c in [(0, 0), (1, 0), (0, 1), (1, 1), (0, 2), (1, 0), (0, 1)]:
        a = mine.ingest(tswitch.Packet(w, c, pay))
        b = ref.ingest(jswitch.Packet(w, c, pay))
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(_bits(a.payload), _bits(b.payload))
        assert mine.stats == ref.stats
    assert mine.stats["stale"] == 1 and mine.stats["duplicates"] == 1
    assert mine.stats["packets"] == 5


def test_rank_overflow_defers_and_preserves_order():
    """8 packets on one slot with rounds_per_call=2: the deferred packets go
    back first, in batch order, and the completing packet carries the
    worker-ordered sum."""
    w, e = 8, 16
    kw = dict(num_workers=w, num_slots=1, elems_per_packet=e, rounds_per_call=2)
    vec = _vec(w, e, seed=4)
    ref, legs = _legs(kw)
    want = ref.ingest_batch(np.arange(w), np.zeros(w, np.int64), vec)
    for name, dp in legs:
        got = dp.ingest_batch(np.arange(w), np.zeros(w, np.int64), vec)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(x), err_msg=name)
        assert got[2].all() and got[0][-1] and not got[0][:-1].any()
    assert legs[0][1].calls == 4 and legs[0][1].rounds_run == 8  # 8 / 2 per call


def test_round_loop_runs_under_deterministic_algorithms():
    vec = _vec(3, 384, seed=8)
    kw = dict(num_workers=3, num_slots=2, elems_per_packet=64, num_pipelines=2,
              variant="full")
    want = tsw.run_aggregation(tsw.BatchedDataplane(tsw.DataplaneConfig(**kw), device=CPU),
                               vec, drop_prob=0.3, seed=2)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = tsw.run_aggregation(tsw.BatchedDataplane(tsw.DataplaneConfig(**kw), device=CPU),
                                  vec, drop_prob=0.3, seed=2)
    finally:
        torch.use_deterministic_algorithms(before)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_without_a_card_the_dataplane_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsw.BatchedDataplane(tsw.DataplaneConfig(num_workers=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tswitch.FpisaSwitch(tswitch.SwitchConfig(num_workers=2))


# ---------------------------------------------------------------------------
# multi-tenancy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drop,seed", [(0.0, 0), (0.3, 7)])
@pytest.mark.parametrize("pipelines", [1, 3])
def test_j1_run_multitenant_equals_run_aggregation(drop, seed, pipelines):
    """With one tenant the multi-tenant driver consumes the RNG as
    run_aggregation does: the same bits on every leg, and the reference's."""
    want = _sweep_reference("fpisa_a", pipelines, drop, seed)[0]
    vec = _sweep_vec(pipelines)
    ref, legs = _legs(_sweep_kw("fpisa_a", pipelines))
    (rflat,), rrep = jsw.run_multitenant(ref, [vec], drop_prob=drop, seed=seed)
    np.testing.assert_array_equal(_bits(rflat), _bits(want))
    for name, dp in legs:
        (got,), rep = tsw.run_multitenant(dp, [vec], drop_prob=drop, seed=seed)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
        assert rep == rrep, name
        assert rep["done_round"][0] == rep["rounds"]


@pytest.mark.parametrize("variant", ["fpisa_a", "full"])
def test_j2_disjoint_quotas_equal_isolated_switches(variant):
    """Equal disjoint quotas, no contention: each tenant's run is the
    reference's and equals an isolated single-tenant switch of its quota."""
    kw2 = dict(num_workers=4, num_slots=8, elems_per_packet=64, num_jobs=2,
               job_slots=(4, 4), job_workers=(4, 4), variant=variant)
    kw1 = dict(num_workers=4, num_slots=4, elems_per_packet=64, variant=variant)
    va, vb = _vec(4, 2048, seed=1), _vec(4, 2048, seed=2)
    ia = tsw.run_aggregation(tsw.BatchedDataplane(tsw.DataplaneConfig(**kw1), device=CPU), va)
    ib = tsw.run_aggregation(tsw.BatchedDataplane(tsw.DataplaneConfig(**kw1), device=CPU), vb)
    ref, legs = _legs(kw2)
    (ra, rb), rrep = jsw.run_multitenant(ref, [va, vb])
    np.testing.assert_array_equal(_bits(ra), _bits(ia))
    for name, dp in legs:
        (fa, fb), rep = tsw.run_multitenant(dp, [va, vb])
        np.testing.assert_array_equal(_bits(fa), _bits(ia), err_msg=name)
        np.testing.assert_array_equal(_bits(fb), _bits(ib), err_msg=name)
        assert rep == rrep, name
        assert all(s["admission_denied"] == 0 and s["preempted"] == 0
                   for s in rep["job_stats"])


def test_j2_overlapping_quotas_under_contention_equal_reference():
    kw = dict(num_workers=5, num_slots=4, elems_per_packet=64, num_pipelines=3,
              num_jobs=2, job_slots=(4, 3), job_workers=(4, 1), job_priorities=(1, 0),
              job_weights=(1, 2), stale_after=2)
    vs = [_vec(4, 2000, seed=11), _vec(1, 1000, seed=12)]
    ref, legs = _legs(kw)
    rflats, rrep = jsw.run_multitenant(ref, vs, drop_prob=0.25, seed=6)
    assert sum(s["admission_denied"] for s in rrep["job_stats"]) > 0
    for name, dp in legs:
        flats, rep = tsw.run_multitenant(dp, vs, drop_prob=0.25, seed=6)
        for got, want in zip(flats, rflats):
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
        assert rep == rrep, name


def test_j3_contention_equals_reference():
    """The reference's contention case: full-overlap quotas, 3 tenants,
    drops; bits, per-job counters and completion rounds."""
    kw = dict(num_workers=9, num_slots=8, elems_per_packet=64, num_jobs=3,
              job_workers=(4, 4, 1), job_priorities=(1, 0, 0), job_weights=(2, 1, 1))
    vs = [_vec(4, 2048, 1), _vec(4, 2048, 2), _vec(1, 512, 3)]
    ref, legs = _legs(kw)
    rflats, rrep = jsw.run_multitenant(ref, vs, drop_prob=0.2, seed=5)
    for name, dp in legs:
        flats, rep = tsw.run_multitenant(dp, vs, drop_prob=0.2, seed=5)
        for got, want in zip(flats, rflats):
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
        assert rep == rrep, name
        total = dp.stats
        assert all(total[n] == sum(s[n] for s in rep["job_stats"]) for n in tsw.COUNTERS)


_ADM = dict(num_workers=2, num_slots=2, elems_per_packet=4, num_jobs=2,
            job_workers=(2, 2), job_priorities=(0, 1), stale_after=3)
# (workers, chunks, payload multiples, jobs, now) per ingest, as the
# reference's admission tests send them
_ADMISSION = {
    "fresh_foreign_denied": [([0, 1], [0, 0], [1, 2], [0, 0], 0), ([0], [0], [3], [1], 1),
                             ([0], [0], [1], [0], 2)],
    "stale_completed_takeover": [([0, 1], [0, 0], [1, 2], [0, 0], 0),
                                 ([0], [0], [3], [1], 6), ([1], [0], [4], [1], 6)],
    "inflight_preemption": [([0], [2], [1], [0], 0), ([0], [2], [5], [1], 1),
                            ([0], [2], [5], [1], 20), ([1], [2], [2], [1], 21)],
}


@pytest.mark.parametrize("case", list(_ADMISSION))
def test_admission_in_lockstep_with_reference(case):
    """Each ingest's ready / results / accepted and the per-job counters
    equal the reference's after every step."""
    ref, legs = _legs(_ADM)
    p = np.ones((1, 4), np.float32)
    for ws, cs, mult, jobs, now in _ADMISSION[case]:
        pay = np.vstack([m * p for m in mult])
        want = ref.ingest_batch(ws, cs, pay, jobs=jobs, now=now)
        for name, dp in legs:
            got = dp.ingest_batch(ws, cs, pay, jobs=jobs, now=now)
            for g, x in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(x), err_msg=name)
            assert dp.job_stats == ref.job_stats, name
    stats = ref.job_stats
    if case == "fresh_foreign_denied":
        assert stats[1]["admission_denied"] == 1
    elif case == "stale_completed_takeover":
        assert [s["preempted"] for s in stats] == [0, 0]
    else:
        assert stats[0]["preempted"] == 1 and stats[1]["preempted"] == 0


def test_per_job_reclaim_only_resets_the_owner_jobs_slots():
    kw = dict(num_workers=2, num_slots=2, elems_per_packet=4, num_jobs=2,
              job_slots=(1, 1), job_workers=(2, 2))
    ref, legs = _legs(kw)
    p = np.ones((1, 4), np.float32)
    steps = [("in", [0], [0], p, [0], 0), ("in", [0], [0], 2 * p, [1], 0),
             ("reclaim", 0, 1), ("in", [1], [0], 3 * p, [0], 1),
             ("in", [1], [0], 5 * p, [1], 1), ("reclaim", 0, 1)]
    for step in steps:
        if step[0] == "reclaim":
            ref.reclaim_worker(step[1], job=step[2])
            for _, dp in legs:
                dp.reclaim_worker(step[1], job=step[2])
        else:
            want = ref.ingest_batch(*step[1:4], jobs=step[4], now=step[5])
            for name, dp in legs:
                got = dp.ingest_batch(*step[1:4], jobs=step[4], now=step[5])
                for g, x in zip(got, want):
                    np.testing.assert_array_equal(np.asarray(g), np.asarray(x), err_msg=name)
        for name, dp in legs:
            assert dp.job_stats == ref.job_stats, name
    assert ref.job_stats[0]["reclaimed"] == 0 and ref.job_stats[1]["reclaimed"] == 1


def test_jain_fairness_equals_reference():
    for xs in ([5.0, 5.0, 5.0], [1.0, 0.0, 0.0], [2.0, 1.0], [0.0, 0.0], [3.5, 1.25, 9.0]):
        assert tsw.jain_fairness(xs) == jsw.jain_fairness(xs)
    assert tsw.jain_fairness([1.0, 0.0, 0.0]) == pytest.approx(1 / 3)


def test_run_multitenant_validates_port_counts():
    cfg = tsw.DataplaneConfig(num_workers=3, num_slots=4, elems_per_packet=64,
                              num_jobs=2, job_workers=(2, 1))
    with pytest.raises(AssertionError):
        tsw.run_multitenant(tsw.NumpyDataplane(cfg), [_vec(2, 128, 0), _vec(2, 128, 1)])


def test_shared_dataplane_registry_create_validate_reset():
    tsw.reset_shared_dataplanes()
    try:
        cfg = tsw.DataplaneConfig(num_workers=2, num_slots=4, num_jobs=2, job_workers=(2, 2))
        dp = tsw.shared_dataplane("t0", cfg)
        assert isinstance(dp, tsw.NumpyDataplane)
        assert tsw.shared_dataplane("t0", cfg) is dp
        other = tsw.DataplaneConfig(num_workers=3, num_slots=4, num_jobs=2,
                                    job_workers=(3, 3))
        with pytest.raises(ValueError, match="mismatched"):
            tsw.shared_dataplane("t0", other)
    finally:
        tsw.reset_shared_dataplanes()


def test_shared_emulated_allreduce_equals_reference():
    """Calls of two tenants alternating on one named switch: the same bits,
    chunk bases, staleness clock and per-job counters as the reference's
    registry."""
    jsw.reset_shared_dataplanes()
    tsw.reset_shared_dataplanes()
    try:
        for call, job in enumerate((0, 1, 0, 1, 1)):
            vals = _vec(2, 700 + 300 * call, seed=call)
            want = jsw.shared_emulated_allreduce("s", vals, num_jobs=2, job=job)
            got = tsw.shared_emulated_allreduce("s", vals, num_jobs=2, job=job)
            np.testing.assert_array_equal(_bits(got), _bits(want))
        cfg = dict(num_workers=2, num_slots=8, elems_per_packet=256, num_jobs=2,
                   job_workers=(2, 2))
        mine = tsw.shared_dataplane("s", tsw.DataplaneConfig(**cfg))
        ref = jsw.shared_dataplane("s", jsw.DataplaneConfig(**cfg))
        assert mine.job_stats == ref.job_stats
        assert mine.job_stats[0]["packets"] > 0 and mine.job_stats[1]["packets"] > 0
    finally:
        jsw.reset_shared_dataplanes()
        tsw.reset_shared_dataplanes()
