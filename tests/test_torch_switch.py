"""The port's switch-arrival aggregation against the JAX reference.

* The FPISA-A and full register adds and ``fpisa_sum_sequential``
  (repro_torch.core.fpisa) on random raw bit patterns, every format: the
  exponent difference d covers each branch (d <= 0, 0 < d <= headroom,
  d > headroom), and the overwrite / overflow events are counted. BIT-EXACT,
  counts equal.
* The numpy switch dataplane (repro_torch.switchsim): ``NumpyDataplane`` +
  ``run_aggregation`` against the reference's on a lossy fabric (drop_prob
  0.1, same seed) and with a worker failing mid-run: the same result bits
  and the same counters.
* The ``fpisa_seq`` (fp32/fp16/bf16) and ``switch_emu`` (fp32) strategies
  through the port's Aggregator at W = 1, 2, 4 on gloo against the JAX
  Aggregator inside shard_map (the harness of tests/test_torch_agg.py):
  BIT-EXACT, on backend "torch" and on the cuda backend's path (K6 through
  ops.accum, its plain version on CPU tensors); and switch_emu == fpisa_seq
  within the port.
* ``switch_emu`` with ``switch_shared``: two jobs' aggregators on one named
  multi-tenant dataplane give the reference's bits and per-job counters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import switchsim as jsw  # noqa: E402
from repro.core import fpisa as jf  # noqa: E402
from repro_torch import switchsim as tsw  # noqa: E402
from repro_torch.core import fpisa as tf  # noqa: E402
from repro_torch.core.agg import AggConfig, Aggregator  # noqa: E402
from test_torch_agg import LEAVES, WORLDS, _bits, run_worlds  # noqa: E402

FMTS = ["fp32", "fp16", "bf16"]
VARIANTS = {"fpisa_a": (jf.fpisa_a_add, tf.fpisa_a_add),
            "full": (jf.fpisa_add_full, tf.fpisa_add_full)}


def _planes(fmt, n, seed):
    """(acc, inp) planes from random raw bit patterns: acc exponents over
    the whole range and acc mantissas over the whole int32 register (a
    register mid-accumulation), incoming exponents acc + d with d in
    -40..40 (plus every headroom edge and an int32 edge), incoming mantissas
    of the format."""
    f = tf.FORMATS[fmt]
    rng = np.random.default_rng(seed)
    ae = rng.integers(0, f.exp_mask, n).astype(np.int32)
    d = rng.integers(-40, 41, n)
    d[:30] = [f.headroom - 1, f.headroom, f.headroom + 1] * 10
    ie = np.clip(ae + d, 0, f.exp_mask - 1).astype(np.int32)
    am = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    am[::3] >>= rng.integers(0, 31, am[::3].size).astype(np.int32)
    am[30:40] = 0
    lim = 1 << (f.man_bits + 1)
    im = rng.integers(-lim + 1, lim, n).astype(np.int32)
    # a register at the int32 edge meeting an equal exponent: the add wraps
    ie[40:50], am[40:50], im[40:50] = ae[40:50], 2**31 - 2, lim - 1
    return ae, am, ie, im


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("fmt", FMTS)
def test_register_adds_bit_exact(fmt, variant):
    ae, am, ie, im = _planes(fmt, 20000, seed=len(fmt) + len(variant))
    jadd, tadd = VARIANTS[variant]
    jp, jst = jadd(jf.Planes(jnp.asarray(ae), jnp.asarray(am)),
                   jf.Planes(jnp.asarray(ie), jnp.asarray(im)), jf.FORMATS[fmt])
    T = torch.from_numpy
    tp, tst = tadd(tf.Planes(T(ae), T(am)), tf.Planes(T(ie), T(im)), tf.FORMATS[fmt])
    np.testing.assert_array_equal(tp.exp.numpy(), np.asarray(jp.exp))
    np.testing.assert_array_equal(tp.man.numpy(), np.asarray(jp.man))
    np.testing.assert_array_equal(tst.overwrite.numpy(), np.asarray(jst.overwrite))
    np.testing.assert_array_equal(tst.overflow.numpy(), np.asarray(jst.overflow))
    d = ie - ae
    h = tf.FORMATS[fmt].headroom
    assert (d <= 0).any() and ((d > 0) & (d <= h)).any() and (d > h).any()
    assert tst.overflow.any()
    assert tst.overwrite.any() == (variant == "fpisa_a")


@pytest.mark.parametrize("workers", [1, 2, 5])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("fmt", FMTS)
def test_sum_sequential_with_stats_bit_exact(fmt, variant, workers):
    """Worker 0 first, on raw bit patterns (NaN patterns made +-inf) of the
    format: the packed result and the overwrite / overflow counts."""
    rng = np.random.default_rng(workers * 7 + len(fmt))
    npdt, tdt = (np.int32, torch.int32) if fmt == "fp32" else (np.int16, torch.int16)
    f = tf.FORMATS[fmt]
    raw = rng.integers(np.iinfo(npdt).min, np.iinfo(npdt).max, (workers, 4000),
                       dtype=np.int64, endpoint=True)
    special = ((raw >> f.man_bits) & f.exp_mask) == f.exp_mask
    raw = np.where(special, raw & ~f.man_mask, raw).astype(npdt)
    xt = torch.from_numpy(raw).view(tf.PACKED_DTYPE[fmt])
    xj = jnp.asarray(raw).view({"fp32": jnp.float32, "fp16": jnp.float16,
                                "bf16": jnp.bfloat16}[fmt])
    out_t, st_t = tf.fpisa_sum_sequential(xt, f, variant, return_stats=True)
    out_j, st_j = jf.fpisa_sum_sequential(xj, jf.FORMATS[fmt], variant, return_stats=True)
    assert out_t.dtype == tf.PACKED_DTYPE[fmt] and out_t.shape == (4000,)
    np.testing.assert_array_equal(out_t.view(tdt).numpy(), np.asarray(out_j).view(npdt))
    assert {k: int(v) for k, v in st_t.items()} == {k: int(v) for k, v in st_j.items()}
    if variant == "fpisa_a" and workers > 1:
        assert int(st_t["overwrite"]) > 0


# ---------------------------------------------------------------------------
# the numpy dataplane and its driver
# ---------------------------------------------------------------------------


def _grads(w, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((w, n)) * np.exp2(rng.integers(-10, 10, (w, n)))
            ).astype(np.float32)


FABRICS = {"lossless": {}, "lossy": dict(drop_prob=0.1, seed=3),
           "fail_worker": dict(drop_prob=0.1, seed=5, fail_worker=2, fail_round=3)}


@pytest.mark.parametrize("fabric", list(FABRICS))
@pytest.mark.parametrize("variant", ["fpisa_a", "full"])
def test_dataplane_matches_reference(fabric, variant):
    """4 workers, 3000 elements (12 chunks over a window of 4 slots x 2
    pipelines): the same result bits and the same counters as the
    reference's numpy dataplane under the same seeded fabric."""
    x = _grads(4, 3000, seed=len(fabric))
    kw = dict(num_workers=4, variant=variant, num_slots=2, num_pipelines=2)
    dj = jsw.NumpyDataplane(jsw.DataplaneConfig(**kw))
    dt = tsw.NumpyDataplane(tsw.DataplaneConfig(**kw))
    want = jsw.run_aggregation(dj, x, **FABRICS[fabric])
    got = tsw.run_aggregation(dt, x, **FABRICS[fabric])
    assert got.dtype == np.float32 and got.shape == (3000,)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert dt.stats == dj.stats
    if fabric != "lossless":
        assert dt.stats["duplicates"] > 0
    if fabric == "fail_worker":
        assert dt.stats["reclaimed"] > 0


def test_dataplane_arrival_order_replays_through_sequential_sum():
    """On a lossy fabric, the recorded per-chunk arrival order replayed
    through the port's fpisa_sum_sequential gives the dataplane's bits."""
    x = _grads(3, 1024, seed=9)
    dp = tsw.NumpyDataplane(tsw.DataplaneConfig(num_workers=3, num_slots=2))
    out, arrivals = tsw.run_aggregation(dp, x, drop_prob=0.2, seed=1, record_arrivals=True)
    assert sorted(arrivals) == list(range(4))
    for c, order in arrivals.items():
        chunk = torch.from_numpy(x[order, c * 256:(c + 1) * 256])
        want = tf.fpisa_sum_sequential(chunk, tf.FP32, "fpisa_a")
        np.testing.assert_array_equal(out[c * 256:(c + 1) * 256].view(np.int32),
                                      want.numpy().view(np.int32))


def test_dataplane_shared_constants_and_refusals():
    """The mirror contract equals the reference's (its two tenancy fields
    included, now that the dataplane is multi-tenant); the numpy dataplane
    and switch_emu stay fp32-only, as in the reference."""
    assert tsw.COUNTERS == jsw.COUNTERS
    assert tsw.SLOT_STATE_FIELDS == jsw.SLOT_STATE_FIELDS
    with pytest.raises(AssertionError, match="fp32-only"):
        tsw.NumpyDataplane(tsw.DataplaneConfig(num_workers=2, fmt_name="bf16"))
    with pytest.raises(ValueError, match="fp32-only"):
        Aggregator(AggConfig(strategy="switch_emu", fmt_name="bf16"))


def test_switch_emu_aggregators_share_one_dataplane():
    """Two jobs' switch_emu aggregators (``switch_job`` 0 and 1) on one named
    dataplane: the reference's bits (tests/test_multitenant.py), which are
    the private switch_emu path's, and both tenants' traffic on the one
    switch, with the reference's per-job counters."""
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.core.agg import AggConfig as JaxAggConfig
    from repro.core.agg import Aggregator as JaxAggregator

    jsw.reset_shared_dataplanes()
    tsw.reset_shared_dataplanes()
    try:
        mesh = compat.make_mesh((1,), ("data",))
        xs = [_grads(1, 600, seed=10 + job)[0] for job in (0, 1)]
        for job, x in enumerate(xs):
            kw = dict(strategy="switch_emu", switch_shared="shared-test", switch_jobs=2,
                      switch_job=job)
            jagg = JaxAggregator(JaxAggConfig(**kw), ("data",))
            want = np.asarray(jax.jit(compat.shard_map(
                jagg.allreduce, mesh=mesh, in_specs=P(), out_specs=P(),
                check_vma=False))(jnp.asarray(x)))
            got = Aggregator(AggConfig(**kw)).allreduce(torch.from_numpy(x)).numpy()
            private = Aggregator(AggConfig(strategy="switch_emu")).allreduce(
                torch.from_numpy(x)).numpy()
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
            np.testing.assert_array_equal(got.view(np.int32), private.view(np.int32))
        cfg = dict(num_workers=1, num_slots=8, elems_per_packet=256, fmt_name="fp32",
                   variant="fpisa_a", num_jobs=2, job_workers=(1, 1))
        mine = tsw.shared_dataplane("shared-test", tsw.DataplaneConfig(**cfg))
        ref = jsw.shared_dataplane("shared-test", jsw.DataplaneConfig(**cfg))
        assert mine.job_stats == ref.job_stats
        assert mine.job_stats[0]["packets"] > 0 and mine.job_stats[1]["packets"] > 0
    finally:
        jsw.reset_shared_dataplanes()
        tsw.reset_shared_dataplanes()


# ---------------------------------------------------------------------------
# the strategies through the Aggregator, W = 1, 2, 4, against JAX
# ---------------------------------------------------------------------------

SEQ_COMBOS = [("fpisa_seq", 32, f) for f in FMTS] + [("switch_emu", 32, "fp32")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, multi_device_runner):
    return run_worlds(tmp_path_factory.mktemp("seq"), SEQ_COMBOS, multi_device_runner, 2025)


SEQ_CASES = [(w, s, f) for w in WORLDS for s, _, f in SEQ_COMBOS]


@pytest.mark.parametrize("world,strategy,fmt", SEQ_CASES,
                         ids=[f"W{w}-{s}-{f}" for w, s, f in SEQ_CASES])
def test_strategy_bit_identical_to_reference(runs, world, strategy, fmt):
    jax_out, torch_ranks, _ = runs[world]
    name = f"{strategy}-w32-{fmt}"
    for rank, res in enumerate(torch_ranks):
        for leaf, shape in LEAVES.items():
            got, want = res[f"{name}/{leaf}"], jax_out[f"{name}/{leaf}"]
            assert got.shape == want.shape == shape and got.dtype == np.float32
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"rank {rank} {leaf}")


@pytest.mark.parametrize("world,fmt", [(w, f) for w in WORLDS for f in FMTS],
                         ids=[f"W{w}-{f}" for w in WORLDS for f in FMTS])
def test_fpisa_seq_kernel_path_bit_identical(runs, world, fmt):
    """The cuda backend's fpisa_seq (ops.accum's float32 over the (W, 1, N)
    stack, cast) equals the reference's jnp scan."""
    jax_out, torch_ranks, _ = runs[world]
    for res in torch_ranks:
        for leaf in LEAVES:
            np.testing.assert_array_equal(_bits(res[f"cuda-fpisa_seq-w32-{fmt}/{leaf}"]),
                                          _bits(jax_out[f"fpisa_seq-w32-{fmt}/{leaf}"]))


@pytest.mark.parametrize("world", WORLDS)
def test_switch_emu_equals_fpisa_seq(runs, world):
    _, torch_ranks, inp = runs[world]
    for res in torch_ranks:
        for leaf in LEAVES:
            np.testing.assert_array_equal(_bits(res[f"switch_emu-w32-fp32/{leaf}"]),
                                          _bits(res[f"fpisa_seq-w32-fp32/{leaf}"]))
            if world == 1:  # one worker: the identity on normal values
                np.testing.assert_array_equal(_bits(res[f"switch_emu-w32-fp32/{leaf}"]),
                                              _bits(inp[leaf][0]))
