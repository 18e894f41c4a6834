"""The port's cost-model autotuner (repro_torch.autotune) against the
reference's (repro.autotune), on the contract of tests/test_autotune.py.

* The affine fit of the same spans equals ``repro.autotune.costmodel.fit``
  (planted exact-affine spans, and spans the port's profiler recorded on
  the CPU), and so do the pipeline recurrence, the candidate sweep, the
  plan sizes and ``choose_bucket_bytes`` (the same pick and the same
  scores) for the same leaf list.
* ``--bucket-bytes auto`` resolves from a trace file, from
  $REPRO_AUTOTUNE_TRACE, and as the loudly warned fallback, through
  ``auto_bucket_bytes`` and ``AggConfig.from_args``.
* The replay profiler runs the registry's split-phase hooks on the CPU,
  each phase a synced span; a strategy without hooks is refused.
* A tuned plan aggregates to the same bits as the default one.
"""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.autotune import costmodel as jcost  # noqa: E402
from repro.autotune import search as jsearch  # noqa: E402
from repro_torch.autotune import costmodel, profile, search  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.agg import AggConfig, Aggregator, add_agg_args  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from test_autotune import LEAVES as JAX_LEAVES  # noqa: E402
from test_autotune import PLANTED_BEST, planted_spans, write_trace  # noqa: E402

LEAVES = [torch.empty(l.shape, dtype=torch.float32, device="meta") for l in JAX_LEAVES]


def _same_model(got, want):
    assert set(got.phases) == set(want.phases) == set(costmodel.PHASES)
    for ph in costmodel.PHASES:
        assert got.phases[ph].a == want.phases[ph].a, ph
        assert got.phases[ph].b == want.phases[ph].b, ph
    assert dict(got.samples) == dict(want.samples)


@pytest.fixture(scope="module")
def probe_spans():
    """Spans of the port's replay profiler on the CPU (world of one)."""
    return profile.profile_phases(AggConfig(strategy="fpisa"), sizes=(256, 1024, 4096),
                                  device="cpu", iters=2, warmup=1)


def test_fit_equals_the_references_on_planted_spans():
    model = costmodel.fit(planted_spans())
    _same_model(model, jcost.fit(planted_spans()))
    assert model.to_dict() == jcost.fit(planted_spans()).to_dict()


def test_fit_equals_the_references_on_profiled_spans(probe_spans):
    assert len(probe_spans) == 3 * 2 * 3
    assert all(sp["synced"] and sp["name"] == "autotune.probe" for sp in probe_spans)
    assert {sp["tags"]["backend"] for sp in probe_spans} == {"torch"}
    model = costmodel.fit(probe_spans)
    _same_model(model, jcost.fit(probe_spans))
    for ph in costmodel.PHASES:
        c = model.phases[ph]
        assert c.a >= 0 and c.b >= 0 and np.isfinite(c.a + c.b)


def test_fit_rejects_single_size_and_unsynced():
    with pytest.raises(ValueError, match="2 distinct"):
        costmodel.fit(planted_spans(sizes=(4096,)))
    spans = planted_spans()
    for sp in spans:
        sp["synced"] = False
    with pytest.raises(ValueError, match="2 distinct"):
        costmodel.fit(spans)


def test_pipeline_time_equals_the_references():
    model, ref = costmodel.fit(planted_spans()), jcost.fit(planted_spans())
    for sizes in ([], [1000], [1000, 2000, 3000], [256] * 7 + [65536]):
        assert model.pipeline_time(sizes) == ref.pipeline_time(sizes)


@pytest.mark.parametrize("total", [1000, 256 << 10, 5 << 20, 1 << 30])
def test_candidates_equal_the_references(total):
    assert search.candidate_bucket_bytes(total) == jsearch.candidate_bucket_bytes(total)


def _smoke_leaves():
    model = build(get_smoke_config("qwen1.5-0.5b"), device=torch.device("cpu"))
    port = [torch.empty(p.shape, dtype=p.dtype, device="meta") for p in model.parameters()]
    ref = [jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32) for p in port]
    return port, ref


@pytest.mark.parametrize("bucket_bytes", [0, 1024, 1 << 16, 4 << 20])
def test_plan_sizes_equal_the_references(bucket_bytes):
    port, ref = _smoke_leaves()
    for p, r in ((port, ref), (LEAVES, JAX_LEAVES)):
        assert search.plan_sizes(p, block=256, bucket_bytes=bucket_bytes) \
            == jsearch.plan_sizes(r, block=256, bucket_bytes=bucket_bytes)


def test_choose_bucket_bytes_equals_the_references(probe_spans):
    port, ref = _smoke_leaves()
    for spans in (planted_spans(), probe_spans):
        model = costmodel.fit(spans)
        for p, r in ((LEAVES, JAX_LEAVES), (port, ref)):
            got = search.choose_bucket_bytes(model, p, block=256)
            assert got == jsearch.choose_bucket_bytes(jcost.fit(spans), r, block=256)
    best, scores = search.choose_bucket_bytes(costmodel.fit(planted_spans()), LEAVES, block=256)
    assert best == PLANTED_BEST and set(scores) == {0, 64 << 10, 128 << 10, 256 << 10}


def test_reference_leaves_match():
    port, ref = search.reference_leaves(), jsearch.reference_leaves()
    assert [tuple(p.shape) for p in port] == [r.shape for r in ref]
    assert all(p.device.type == "meta" and p.dtype == torch.float32 for p in port)


def test_auto_from_trace_file_and_env(tmp_path, monkeypatch):
    path = write_trace(tmp_path / "t.jsonl", planted_spans())
    monkeypatch.delenv(search.TRACE_ENV, raising=False)
    assert search.auto_bucket_bytes(trace_path=path, block=256, leaves=LEAVES) == PLANTED_BEST
    monkeypatch.setenv(search.TRACE_ENV, path)
    assert search.auto_bucket_bytes(block=256, leaves=LEAVES) == PLANTED_BEST
    # the synthetic workload when the tree is unknown: the reference's pick
    assert search.auto_bucket_bytes() == jsearch.auto_bucket_bytes()


def test_auto_without_trace_falls_back_loudly(tmp_path, monkeypatch):
    monkeypatch.delenv(search.TRACE_ENV, raising=False)
    with pytest.warns(UserWarning, match="falling back"):
        assert search.auto_bucket_bytes() == search.DEFAULT_AUTO_BUCKET_BYTES
    with pytest.warns(UserWarning, match="missing file"):
        got = search.auto_bucket_bytes(trace_path=str(tmp_path / "no.jsonl"))
    assert got == search.DEFAULT_AUTO_BUCKET_BYTES == jsearch.DEFAULT_AUTO_BUCKET_BYTES


def _parse(argv):
    ap = argparse.ArgumentParser()
    add_agg_args(ap)
    return ap.parse_args(argv)


def test_from_args_resolves_bucket_bytes(tmp_path, monkeypatch):
    monkeypatch.delenv(search.TRACE_ENV, raising=False)
    assert AggConfig.from_args(_parse(["--bucket-bytes", "4096"])).bucket_bytes == 4096
    path = write_trace(tmp_path / "t.jsonl", planted_spans())
    cfg = AggConfig.from_args(_parse(["--bucket-bytes", "auto", "--autotune-trace", path]))
    assert cfg.bucket_bytes == jsearch.auto_bucket_bytes(trace_path=path)
    with pytest.warns(UserWarning, match="falling back"):
        cfg = AggConfig.from_args(_parse(["--bucket-bytes", "auto"]))
    assert cfg.bucket_bytes == search.DEFAULT_AUTO_BUCKET_BYTES
    with pytest.raises(SystemExit):
        _parse(["--bucket-bytes", "lots"])


def test_profile_rejects_non_split_phase_strategy_and_bad_sizes():
    with pytest.raises(ValueError, match="split-phase"):
        profile.profile_phases(AggConfig(strategy="native"), sizes=(256,), device="cpu")
    with pytest.raises(ValueError, match="block multiples"):
        profile.profile_phases(AggConfig(), sizes=(300,), device="cpu")
    assert profile.probe_sizes() == (256, 1024, 4096, 16384, 65536, 262144)


def test_profile_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the CPU-only refusal is what is tested")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.profile_phases(sizes=(256,))


def test_profiled_trace_feeds_auto_through_a_file(tmp_path, probe_spans):
    from repro_torch import trace

    path = trace.write_jsonl(probe_spans, tmp_path / "probe.jsonl")
    got = search.auto_bucket_bytes(trace_path=path, leaves=LEAVES)
    assert got == jsearch.auto_bucket_bytes(trace_path=path, leaves=JAX_LEAVES)


def test_tuned_plan_is_bit_identical_to_default(tmp_path):
    rng = np.random.default_rng(3)
    tree = {f"l{i}": torch.from_numpy((rng.standard_normal(n) * 0.01).astype(np.float32))
            for i, n in enumerate((2048, 777, 4096, 13))}
    path = write_trace(tmp_path / "t.jsonl", planted_spans())
    tuned = search.auto_bucket_bytes(
        trace_path=path, block=256,
        leaves=[torch.empty(v.shape, device="meta") for v in tree.values()])
    a = Aggregator(AggConfig()).allreduce_tree(tree)
    for bucket_bytes in {tuned, 4096, PLANTED_BEST} - {0}:  # 0 is the default itself
        b = Aggregator(AggConfig(bucket_bytes=bucket_bytes)).allreduce_tree(tree)
        for k in tree:
            assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), k
