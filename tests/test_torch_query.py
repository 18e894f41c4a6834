"""The port's in-switch query processing (repro_torch.switchsim.query,
repro_torch.db.query, repro_torch.launch.query) against the JAX reference,
the counterpart of tests/test_db.py and of the query cases of
tests/test_switchsim.py and tests/test_multitenant.py. Inputs are numpy,
made from seeds; the port runs on the CPU.

* ``topn_keep`` and ``groupby_ingest`` equal the reference's bit for bit
  (keep mask; ``exp``, ``man``, ``since``, ``deferred``), with flushes due
  and rows deferred.
* ``TopNPruner``: the survivors equal the reference's, the exact top N is
  among them, the prune rate is above 0.9.
* ``GroupBySum``: the slot planes equal the reference's bit for bit, within
  the reference's error bounds of the exact sums (2e-3 and 5e-5).
* ``StreamedGroupBySum`` through ``run_multitenant`` beside a training job:
  the reference's bits, totals within rel 1e-4 of ``spark_like_groupby``.
* ``python -m repro_torch.launch.query --device cpu`` prints the example's
  lines; without a card the operators and the launcher raise.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import switchsim as jsw  # noqa: E402
from repro.core import fpisa as jf  # noqa: E402
from repro.db import query as jq  # noqa: E402
from repro.switchsim import query as jswq  # noqa: E402
from repro_torch import switchsim as tsw  # noqa: E402
from repro_torch.core import fpisa as tf  # noqa: E402
from repro_torch.db import query as tq  # noqa: E402
from repro_torch.launch import query as query_cli  # noqa: E402
from repro_torch.switchsim import query as tswq  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _wide(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * np.exp2(rng.integers(-12, 12, n))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("fmt", ["fp32", "fp16", "bf16"])
def test_topn_keep_equals_reference(fmt):
    vals = _wide(2048, seed=1)
    vals[:4] = [0.37, -0.37, np.inf, np.nan]
    t = jf.encode(jnp.float32(0.37), jf.FORMATS[fmt])
    want = np.asarray(jswq.topn_keep(jnp.asarray(vals), t.exp, t.man, fmt_name=fmt))
    got = tswq.topn_keep(_t(vals), int(t.exp), int(t.man), fmt_name=fmt)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("variant,flush_every,rounds", [
    ("full", 8, 64), ("fpisa_a", 8, 64), ("full", 64, 16), ("full", 3, 5)])
def test_groupby_ingest_equals_reference(variant, flush_every, rounds):
    """64 rows over 4 slots from a non-zero register state; ``rounds`` 5
    and 16 defer rows (the largest multiplicity is about 20)."""
    rng = np.random.default_rng(flush_every + rounds)
    nslots, rows = 4, 64
    keys = rng.integers(0, nslots, rows).astype(np.int32)
    vals = (rng.standard_normal(rows) * 10).astype(np.float32)
    valid = rng.random(rows) > 0.1
    start = jf.encode(jnp.asarray([3.0, -7.5, 0.0, 1e6], jnp.float32))
    since = np.array([0, 2, 7, 1], np.int32)
    jout = jswq.groupby_ingest(start.exp, start.man, jnp.asarray(since), jnp.asarray(keys),
                               jnp.asarray(vals), jnp.asarray(valid), num_slots=nslots,
                               rounds=rounds, variant=variant, flush_every=flush_every)
    tout = tswq.groupby_ingest(_t(np.asarray(start.exp)), _t(np.asarray(start.man)),
                               _t(since), _t(keys), _t(vals), _t(valid), num_slots=nslots,
                               rounds=rounds, variant=variant, flush_every=flush_every)
    for name, g, w in zip(("exp", "man", "since", "deferred"), tout, jout):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    most = np.bincount(keys[valid], minlength=nslots).max()
    assert bool(np.asarray(jout[3]).any()) == (most > rounds)
    assert (most > rounds) == (rounds < 64)


def test_comparison_via_subtraction_sign():
    a = tf.encode(torch.tensor([3.0, -1.0, 0.5]))
    b = tf.encode(torch.tensor([2.0, 1.0, 0.5]))
    np.testing.assert_array_equal(tq._cmp_planes(a, b).numpy(), [True, False, False])
    ja = jf.encode(jnp.asarray([3.0, -1.0, 0.5], jnp.float32))
    jb = jf.encode(jnp.asarray([2.0, 1.0, 0.5], jnp.float32))
    np.testing.assert_array_equal(tq._cmp_planes(a, b).numpy(), jq._cmp_planes(ja, jb))


@pytest.mark.parametrize("case", ["normal", "zipf", "gamma"])
def test_topn_pruner_exact_and_effective(case):
    """The reference's cases (20,000 normal rows, top 10; 5,000 zipf rows,
    top 5) and the example's adRevenue column; survivors and stats equal
    the reference's."""
    n, batch = 10, 256
    if case == "normal":
        vals = (np.random.default_rng(42).standard_normal(20000) * 100).astype(np.float32)
    elif case == "zipf":
        vals, n = np.random.default_rng(1).zipf(1.5, 5000).astype(np.float32), 5
    else:
        vals, batch = np.random.default_rng(1).gamma(2.0, 50.0, 100_000).astype(np.float32), 4096
    mine = tq.TopNPruner(n=n, device=CPU)
    surv = mine.run(vals, batch=batch)
    ref = jq.TopNPruner(n=n)
    np.testing.assert_array_equal(surv, ref.run(vals, batch=batch))
    assert vars(mine.stats) == vars(ref.stats)
    np.testing.assert_array_equal(np.sort(vals[surv])[::-1][:n], tq.spark_like_topn(vals, n))
    if case != "zipf":
        assert mine.stats.prune_rate > 0.9, mine.stats


def test_topn_pruner_takes_a_column_already_on_the_device():
    vals = _wide(5000, seed=3)
    a = tq.TopNPruner(n=7, device=CPU).run(vals)
    b = tq.TopNPruner(n=7, device=CPU).run(torch.from_numpy(vals))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["normal", "revenue", "example"])
def test_groupby_sum_planes_equal_reference_within_bounds(case):
    """The reference's cases: 5,000 normal rows over 32 groups (error <=
    2e-3 x max(1, |sum|)), 8,000 uniform revenue rows over 16 groups (rel
    5e-5), and the example's 20,000-row adRevenue group-by (rel 5e-5);
    a small batch makes the planes cross batches and flush."""
    if case == "normal":
        rng = np.random.default_rng(2)
        slots, keys = 32, rng.integers(0, 32, 5000)
        vals = (rng.standard_normal(5000) * 10).astype(np.float32)
    elif case == "revenue":
        rng = np.random.default_rng(3)
        slots, keys = 16, rng.integers(0, 16, 8000)
        vals = rng.uniform(1.0, 1000.0, 8000).astype(np.float32)
    else:
        rng = np.random.default_rng(1)
        vals = rng.gamma(2.0, 50.0, 100_000).astype(np.float32)[:20000]
        slots, keys = 32, rng.integers(0, 32, 100_000)[:20000]
    batch = 1024 if case == "normal" else 65536
    mine = tq.GroupBySum(num_slots=slots, variant="full", device=CPU)
    got = mine.run(keys, vals, batch=batch)
    ref = jq.GroupBySum(num_slots=slots, variant="full")
    want = ref.run(keys, vals, batch=batch)
    np.testing.assert_array_equal(mine.exp.numpy(), ref.exp)
    np.testing.assert_array_equal(mine.man.numpy(), ref.man)
    np.testing.assert_array_equal(mine.since.numpy(), ref.since)
    assert got == want and vars(mine.stats) == vars(ref.stats)
    exact = tq.spark_like_groupby(keys, vals)
    assert exact == jq.spark_like_groupby(keys, vals)
    for k, v in exact.items():
        if case == "normal":
            assert abs(got[k] - v) < 2e-3 * max(1.0, abs(v)), (k, got[k], v)
        else:
            assert abs(got[k] - v) / v < 5e-5
    assert mine.stats.rows_out == len(exact)


def test_streamed_groupby_shares_the_switch_with_a_training_job():
    """The reference's case (tests/test_multitenant.py): a one-port query
    stream and a 4-worker training job on one switch, drops 0.1; the port's
    batched and numpy dataplanes give the reference's bits, and the query
    totals are within rel 1e-4 of the exact sums."""
    rng = np.random.default_rng(42)
    keys = rng.integers(0, 16, size=20_000)
    values = (rng.standard_normal(20_000) * 3).astype(np.float32)
    gb = tq.StreamedGroupBySum(num_groups=16, elems_per_packet=64)
    qvec = gb.vectors(keys, values, batch=2048)
    np.testing.assert_array_equal(
        qvec, jq.StreamedGroupBySum(num_groups=16, elems_per_packet=64).vectors(
            keys, values, batch=2048))
    train = (np.random.default_rng(8).standard_normal((4, 2048)) * 0.01).astype(np.float32)
    kw = dict(num_workers=5, num_slots=8, elems_per_packet=64, num_jobs=2,
              job_workers=(4, 1), job_priorities=(1, 0))
    (rt, rq), rrep = jsw.run_multitenant(jsw.NumpyDataplane(jsw.DataplaneConfig(**kw)),
                                         [train, qvec], drop_prob=0.1, seed=4)
    want = tq.spark_like_groupby(keys, values)
    for dp in (tsw.BatchedDataplane(tsw.DataplaneConfig(**kw), device=CPU),
               tsw.NumpyDataplane(tsw.DataplaneConfig(**kw))):
        (tflat, qflat), rep = tsw.run_multitenant(dp, [train, qvec], drop_prob=0.1, seed=4)
        np.testing.assert_array_equal(tflat.view(np.int32), rt.view(np.int32))
        np.testing.assert_array_equal(qflat.view(np.int32), rq.view(np.int32))
        assert rep == rrep
        got = gb.finalize(qflat)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-4)
        assert np.max(np.abs(tflat.astype(np.float64) - train.astype(np.float64).sum(0))) < 0.1
        assert all(d is not None for d in rep["done_round"])


def test_without_a_card_the_operators_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tq.TopNPruner(n=3), lambda: tq.GroupBySum(num_slots=4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        query_cli.main(["--rows", "1000"])


def test_query_cli_on_cpu_prints_the_examples_lines():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.query", "--device", "cpu",
         "--rows", "100000", "--group-rows", "20000"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300, check=True).stdout
    assert "Top-10: switch pruned 95.9% of the stream (4,131 rows reached the master)" in out
    assert "Group-by SUM: only 32 aggregates left the switch (from 20,000 rows)" in out
