"""The port's serving path against the JAX reference, at smoke size:
qwen1.5-0.5b-smoke in float32 (and a GQA variant, ``num_kv_heads=2``),
both sides starting from the SAME weights (the JAX init, carried over with
repro_torch.interop.params_from_jax); inputs made with numpy from seeds.

* ``prefill``, ``decode_step`` and ``decode_step_paged`` logits against the
  JAX functions within 2e-5 absolute (the training tolerance: float32 in
  two frameworks differs in summation order and transcendentals); the K/V
  they write to the cache and to the pool within 1e-6.
* ``train/step.py::make_serve_steps``' pair equals the model's methods bit
  for bit, and its greedy tokens equal the reference's ``make_serve_steps``'.
* Within the port, bit for bit: paged decode equals dense decode at equal
  B, and every row's prefill and decode logits equal that row's alone
  (batch invariance, ``models/transformer.py``).
* The reference's allocator, paged-cache, admission, backpressure,
  retirement and packing cases (``tests/test_serve.py``), on the port.
* Continuous equal to the static engine run one request at a time, token
  for token, on the reference's mixed Poisson trace (seed 7).
* Both engines' tokens equal the JAX engines' on the same requests.
* Telemetry through the ``Aggregator`` facade (``fpisa``, ``fpisa_seq``,
  and ``switch_emu`` on a shared multi-tenant dataplane) equals the run
  without one and the JAX ``TelemetryChannel``'s totals.
* ``PoissonLoadGen`` traces equal the reference's for the same seed.
* ``python -m repro_torch.launch.serve --device cpu --smoke`` runs for both
  engines; without ``--device cpu`` and without a card it raises.
"""
import math
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.agg import AggConfig as JaxAggConfig  # noqa: E402
from repro.models.registry import build as jax_build  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.serve import loadgen as jax_loadgen  # noqa: E402
from repro.serve import scheduler as jax_scheduler  # noqa: E402
from repro.train import step as jax_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.agg import AggConfig  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.models.transformer import DECODE_ROWS, decode_rows, select_rows  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine, TelemetryChannel  # noqa: E402
from repro_torch.serve.kvcache import PageAllocator, PagedKVCache, pages_needed  # noqa: E402
from repro_torch.serve.loadgen import PoissonLoadGen, latency_report, percentile  # noqa: E402
from repro_torch.serve.scheduler import ContinuousEngine  # noqa: E402
from repro_torch.train.step import make_serve_steps  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen1.5-0.5b"
CPU = torch.device("cpu")
VARIANTS = {"mha": {}, "gqa": {"num_kv_heads": 2}}
LOGIT_ATOL, KV_ATOL = 2e-5, 1e-6


@pytest.fixture(scope="module")
def pair():
    """variant -> (JAX model, JAX params, port model on the CPU), built once
    per module, the port's weights carried over from the JAX init."""
    built = {}

    def get(variant="mha"):
        if variant not in built:
            jm = jax_build(jax_smoke(ARCH).with_(**VARIANTS[variant]))
            jp = jm.init(jax.random.PRNGKey(0))
            pm = build(get_smoke_config(ARCH).with_(**VARIANTS[variant]), device=CPU,
                       params=params_from_jax(jax.tree.map(np.asarray, jp)))
            built[variant] = (jm, jp, pm)
        return built[variant]

    return get


@pytest.fixture(scope="module")
def model(pair):
    return pair()[2]


def _prompt(rng, n, vocab):
    return rng.integers(0, vocab, n).astype(np.int32)


def _requests(reqs):
    """Fresh copies (engines may replace a request on truncation)."""
    return [Request(r.rid, np.array(r.prompt), r.max_new_tokens) for r in reqs]


def _oracle(model, reqs, max_len):
    """Static engine, one request per run: the bit-identity reference."""
    out = {}
    for r in reqs:
        eng = ServeEngine(model, batch_size=1, max_len=max_len)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = eng.run(_requests([r]))
        if res:
            out[r.rid] = res[0].tokens
    return out


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the model's serving functions against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_step_match_jax(pair, variant):
    jm, jp, pm = pair(variant)
    cfg = pm.cfg
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 16))
    pl, pc = pm.prefill(torch.from_numpy(toks), pm.init_cache(2, 16))
    np.testing.assert_allclose(_np(pl), np.asarray(jl), rtol=0, atol=LOGIT_ATOL)
    assert pc.pos == int(jc.pos) == 8
    for mine, ref in ((pc.kv.k, jc.kv.k), (pc.kv.v, jc.kv.v)):
        np.testing.assert_allclose(_np(mine[:, :2]), np.asarray(ref), rtol=0, atol=KV_ATOL)
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        pl, pc = pm.decode_step(torch.from_numpy(nxt), pc)
        np.testing.assert_allclose(_np(pl), np.asarray(jl), rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"decode step {step}")
        assert pc.pos == int(jc.pos) == 9 + step
        for mine, ref in ((pc.kv.k, jc.kv.k), (pc.kv.v, jc.kv.v)):
            np.testing.assert_allclose(_np(mine[:, :2]), np.asarray(ref), rtol=0,
                                       atol=KV_ATOL)


def _greedy(prefill, decode, batch, cache, steps):
    """Greedy tokens (B, 1 + steps) and every step's logits."""
    logits, cache = prefill(batch, cache)
    outs = [logits]
    for _ in range(steps):
        logits, cache = decode(logits.argmax(-1), cache)
        outs.append(logits)
    return [o.argmax(-1) for o in outs], outs


def test_make_serve_steps_are_the_methods_and_give_the_reference_tokens(pair):
    """The pair equals the model's ``prefill``/``decode_step`` bit for bit,
    and its greedy tokens equal the reference's ``make_serve_steps``'."""
    jm, jp, pm = pair()
    toks = np.random.default_rng(11).integers(0, pm.cfg.vocab_size, (2, 8)).astype(np.int32)
    prefill, decode = make_serve_steps(pm)
    got_t, got_l = _greedy(prefill, decode, {"tokens": torch.from_numpy(toks)},
                           pm.init_cache(2, 16), 4)
    want_t, want_l = _greedy(lambda b, c: pm.prefill(b["tokens"], c), pm.decode_step,
                             {"tokens": torch.from_numpy(toks)}, pm.init_cache(2, 16), 4)
    for g, w in zip(got_l, want_l):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    jprefill, jdecode = jax_step.make_serve_steps(jm, None)
    ref_t, _ = _greedy(lambda b, c: jprefill(jp, b, c), lambda t, c: jdecode(jp, t, c),
                       {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 16), 4)
    np.testing.assert_array_equal(np.concatenate([_np(t) for t in got_t], 1),
                                  np.concatenate([np.asarray(t) for t in ref_t], 1))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_step_paged_matches_jax(pair, variant):
    """The same pools, table and lengths into both: per-slot positions,
    scratch-page rows, in-place pool writes."""
    jm, jp, pm = pair(variant)
    cfg = pm.cfg
    rng = np.random.default_rng(11)
    page, mp = 8, 4
    shape = (cfg.num_layers, 1 + 3 * mp, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    k_pool = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    v_pool = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    table = np.zeros((3, mp), np.int32)
    table[0] = [1, 2, 3, 4]
    table[2] = [9, 5, 0, 0]           # slot 1 idle: every entry on scratch page 0
    lens = np.array([19, 0, 13], np.int32)
    jk, jv, pk, pv = (jnp.asarray(k_pool), jnp.asarray(v_pool),
                      torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy()))
    for step in range(2):
        nxt = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        jl, jk, jv = jm.decode_step_paged(jp, jnp.asarray(nxt), jk, jv, jnp.asarray(table),
                                          jnp.asarray(lens))
        pl, pk, pv = pm.decode_step_paged(torch.from_numpy(nxt), pk, pv,
                                          torch.from_numpy(table), torch.from_numpy(lens))
        live = [0, 2]
        np.testing.assert_allclose(_np(pl)[live], np.asarray(jl)[live], rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"paged step {step}")
        live_pages = slice(1, None)   # page 0 takes the idle slots' duplicate writes
        np.testing.assert_allclose(_np(pk)[:, live_pages], np.asarray(jk)[:, live_pages],
                                   rtol=0, atol=KV_ATOL)
        np.testing.assert_allclose(_np(pv)[:, live_pages], np.asarray(jv)[:, live_pages],
                                   rtol=0, atol=KV_ATOL)
        lens = lens + np.array([1, 0, 1], np.int32)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_attention_decode_layer_matches_jax(pair, variant, paged):
    """One layer's ``attention_decode`` (on a cache from ``init_kv_cache``)
    or ``attention_decode_paged`` (the reference's signature: the step's
    index computed inside) against the JAX function."""
    from repro.models import attention as jax_attn

    jm, jp, pm = pair(variant)
    cfg = pm.cfg
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kv = (0.1 * rng.standard_normal((2, 2, 16, cfg.num_kv_heads, cfg.resolved_head_dim))
          ).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    lp_t = {k: t[0].detach() for k, t in pm.layers["attn"].items()}
    if paged:  # the same values as 8 pages of 4: slot j owns pages 1 + 4j ..
        pools = np.concatenate([np.zeros((2, 1, 4) + kv.shape[3:], np.float32),
                                kv.reshape(2, 8, 4, *kv.shape[3:])], axis=1)
        table = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
        lens = np.array([5, 11], np.int32)
        jout, jk, jv = jax_attn.attention_decode_paged(
            lp, jnp.asarray(x), jm.cfg, jnp.asarray(pools[0]), jnp.asarray(pools[1]),
            jnp.asarray(table), jnp.asarray(lens))
        k_pool, v_pool = (torch.from_numpy(a.copy()) for a in pools)
        out, k_pool, v_pool = attn.attention_decode_paged(
            lp_t, torch.from_numpy(x), cfg, k_pool, v_pool, torch.from_numpy(table),
            torch.from_numpy(lens))
        got, want = (k_pool, v_pool), (jk, jv)
    else:
        jout, jcache = jax_attn.attention_decode(lp, jnp.asarray(x), jm.cfg,
                                                 jax_attn.KVCache(*map(jnp.asarray, kv)), 5)
        cache = attn.init_kv_cache(2, 16, cfg, torch.float32, CPU)
        cache.k.copy_(torch.from_numpy(kv[0]))
        cache.v.copy_(torch.from_numpy(kv[1]))
        out, cache = attn.attention_decode(lp_t, torch.from_numpy(x), cfg, cache, 5)
        got, want = cache, jcache
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=0, atol=LOGIT_ATOL)
    for mine, ref in zip(got, want):
        np.testing.assert_allclose(_np(mine), np.asarray(ref), rtol=0, atol=KV_ATOL)


# ---------------------------------------------------------------------------
# within the port, bit for bit
# ---------------------------------------------------------------------------


def _filled(pm, prompts, max_len, page):
    """A dense cache and a paged cache holding the same prefill of
    ``prompts`` (n, s); slot j owns pages in reverse order."""
    n, s = prompts.shape
    logits, cache = pm.prefill(torch.from_numpy(prompts), pm.init_cache(n, max_len))
    paged = PagedKVCache(pm.cfg, num_slots=n, max_len=max_len, page_size=page)
    for j in reversed(range(n)):
        assert paged.grow_slot(j, s)
        paged.write_prompt(j, cache.kv.k[:, j, :s], cache.kv.v[:, j, :s])
    return logits, cache, paged


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_paged_decode_equals_dense_decode_bitwise(pair, variant):
    pm = pair(variant)[2]
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, pm.cfg.vocab_size, (3, 10)).astype(np.int32)
    logits, cache, paged = _filled(pm, prompts, max_len=32, page=8)
    nxt = logits[:, -1].argmax(-1)[:, None]
    for step in range(4):
        for j in range(3):
            assert paged.grow_slot(j, 11 + step)
        lens = torch.full((3,), 10 + step)
        dl, cache = pm.decode_step(nxt, cache)
        ql, _, _ = pm.decode_step_paged(nxt, paged.k, paged.v, paged.device_table(), lens)
        assert torch.equal(dl, ql), f"step {step}: paged logits != dense logits"
        for j in range(3):
            view = paged.k[:, torch.from_numpy(paged.page_table[j])].flatten(1, 2)
            assert torch.equal(view[:, :11 + step], cache.kv.k[:, j, :11 + step])
        nxt = dl[:, -1].argmax(-1)[:, None]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rows_do_not_depend_on_the_batch(pair, variant):
    """A row's prefill and decode logits equal that row's alone, bit for
    bit, whatever shares the call: the batch invariance the continuous
    engine's oracle contract rests on."""
    pm = pair(variant)[2]
    rng = np.random.default_rng(14)
    prompts = rng.integers(0, pm.cfg.vocab_size, (4, 7)).astype(np.int32)
    nxt = torch.from_numpy(rng.integers(0, pm.cfg.vocab_size, (4, 1)))
    logits, cache, paged = _filled(pm, prompts, max_len=16, page=4)
    for j in range(4):
        assert paged.grow_slot(j, 8)
    together, _ = pm.decode_step(nxt, cache)
    together_paged, _, _ = pm.decode_step_paged(nxt, paged.k, paged.v, paged.device_table(),
                                                torch.full((4,), 7))
    for j in range(4):
        alone, one = pm.prefill(torch.from_numpy(prompts[j:j + 1]), pm.init_cache(1, 16))
        assert torch.equal(alone[0], logits[j]), f"prefill row {j}"
        alone, _ = pm.decode_step(nxt[j:j + 1], one)
        assert torch.equal(alone[0], together[j]), f"decode row {j}"
        alone, _, _ = pm.decode_step_paged(nxt[j:j + 1], paged.k, paged.v,
                                           paged.device_table()[j:j + 1], torch.tensor([7]))
        assert torch.equal(alone[0], together_paged[j]), f"paged decode row {j}"


def test_decode_rows_and_select_rows(model):
    assert [decode_rows(b) for b in (0, 1, DECODE_ROWS, DECODE_ROWS + 1)] == \
        [DECODE_ROWS, DECODE_ROWS, DECODE_ROWS, 2 * DECODE_ROWS]
    cache = model.init_cache(3, 8)
    assert cache.kv.k.shape[1] == DECODE_ROWS
    with torch.inference_mode():  # the caches are inference tensors
        cache.kv.k[:, :3] = torch.arange(3.0)[None, :, None, None, None]
    picked = select_rows(cache, [2, 0])
    assert picked.kv.k.shape[1] == DECODE_ROWS
    assert picked.kv.k[:, 0].eq(2).all() and picked.kv.k[:, 1].eq(0).all()
    assert picked.kv.k[:, 2:].eq(2).all()  # padding rows copy the first
    with pytest.raises(ValueError, match="multiple of DECODE_ROWS"):
        model.decode_step(torch.zeros((2, 1), dtype=torch.long),
                          model.init_cache(2, 8, rows=2))


# ---------------------------------------------------------------------------
# allocator and paged cache (the reference's cases)
# ---------------------------------------------------------------------------


def test_allocator_roundtrip_and_reuse():
    a = PageAllocator(num_pages=4, page_size=8)
    assert a.alloc(3) == [1, 2, 3] and a.in_use == 3 and a.available == 1
    a.free([2])
    assert a.alloc(2) == [2, 4]  # freed page reused, lowest id first
    assert a.in_use == 4 and a.peak_in_use == 4


@pytest.mark.parametrize("bad", ["twice", "never_allocated"])
def test_allocator_no_double_free(bad):
    a = PageAllocator(num_pages=2, page_size=8)
    pages = a.alloc(2)
    a.free(pages)
    with pytest.raises(ValueError, match="double free"):
        a.free([pages[0]] if bad == "twice" else [99])


def test_allocator_exhaustion_is_not_partial():
    a = PageAllocator(num_pages=3, page_size=8)
    assert a.alloc(2) is not None
    assert a.alloc(2) is None   # only 1 left: refuse the whole request
    assert a.available == 1     # nothing was taken by the failed alloc
    assert a.alloc(1) is not None
    with pytest.raises(ValueError):
        a.alloc(-1)
    with pytest.raises(ValueError):
        PageAllocator(num_pages=0, page_size=8)


@pytest.mark.parametrize("n, want", [(0, 0), (1, 1), (8, 1), (9, 2), (-3, 0)])
def test_pages_needed(n, want):
    assert pages_needed(n, 8) == want


@pytest.mark.parametrize("cfg_kw, max_len, match", [
    ({}, 30, "must divide"), ({"family": "ssm"}, 32, "paged KV serving supports")])
def test_paged_cache_guards(model, cfg_kw, max_len, match):
    with pytest.raises(ValueError, match=match):
        PagedKVCache(model.cfg.with_(**cfg_kw), num_slots=2, max_len=max_len, page_size=8)


def test_paged_cache_slot_isolation_and_table_upload(model):
    cache = PagedKVCache(model.cfg, num_slots=3, max_len=32, page_size=8)
    assert cache.k.shape == (model.cfg.num_layers, 13, 8, model.cfg.num_kv_heads,
                             model.cfg.resolved_head_dim)
    assert cache.grow_slot(0, 9)   # 2 pages
    assert cache.grow_slot(2, 17)  # 3 pages
    table = cache.device_table()
    assert cache.device_table() is table  # no write: no re-upload
    p0, p2 = set(cache.slot_pages(0)), set(cache.slot_pages(2))
    assert p0 and p2 and not (p0 & p2), "live slots must own disjoint pages"
    assert 0 not in p0 | p2, "scratch page 0 is never allocated"
    cache.release_slot(0)
    assert (cache.page_table[0] == 0).all() and cache.pages_in_use == 3
    assert cache.device_table() is not table and cache.device_table()[0].eq(0).all()
    assert cache.grow_slot(1, 32)  # 4 pages: needs the freed ones
    assert cache.pages_in_use == 7
    with pytest.raises(ValueError, match="pages_per_slot"):
        cache.grow_slot(1, 33)


# ---------------------------------------------------------------------------
# admission, backpressure, retirement, packing (the reference's cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["continuous", "static"])
@pytest.mark.parametrize("plen, match", [(0, "zero-length"), (17, "exceeds engine max_len")])
def test_admission_rejects_empty_and_overlong_prompts(model, engine, plen, match):
    rng = np.random.default_rng(0)
    bad = Request(rid=0, prompt=_prompt(rng, plen, model.cfg.vocab_size), max_new_tokens=4)
    eng = (ContinuousEngine(model, num_slots=2, max_len=16) if engine == "continuous"
           else ServeEngine(model, batch_size=2, max_len=16))
    with pytest.warns(UserWarning, match=match):
        assert eng.run([bad]) == []
    assert eng.telemetry["rejected"] == 1


def test_admission_prompt_equals_max_len(model):
    """A full-cache prompt still yields its one prefill-logits token, with
    zero decode steps, identical to the static oracle."""
    rng = np.random.default_rng(1)
    req = Request(rid=0, prompt=_prompt(rng, 16, model.cfg.vocab_size), max_new_tokens=7)
    eng = ContinuousEngine(model, num_slots=2, max_len=16, page_size=8)
    with pytest.warns(UserWarning, match="truncated to 1"):
        (res,) = eng.run(_requests([req]))
    assert res.tokens.shape == (1,)
    assert eng.telemetry["decode_steps"] == 0 and eng.telemetry["truncated"] == 1
    np.testing.assert_array_equal(res.tokens, _oracle(model, [req], max_len=16)[0])


def test_admission_max_new_exactly_fits(model):
    """max_new == max_len - plen + 1: admitted untruncated, fills the cache
    to the last position without overrun."""
    rng = np.random.default_rng(2)
    req = Request(rid=3, prompt=_prompt(rng, 6, model.cfg.vocab_size), max_new_tokens=11)
    eng = ContinuousEngine(model, num_slots=1, max_len=16, page_size=4)
    (res,) = eng.run(_requests([req]))
    assert res.tokens.shape == (11,)
    assert eng.telemetry["truncated"] == 0
    np.testing.assert_array_equal(res.tokens, _oracle(model, [req], max_len=16)[3])


def test_admission_whole_pool_infeasible_rejected(model):
    rng = np.random.default_rng(3)
    eng = ContinuousEngine(model, num_slots=2, max_len=32, page_size=8, num_pages=2)
    with pytest.warns(UserWarning, match="whole pool"):
        out = eng.run([Request(0, _prompt(rng, 20, model.cfg.vocab_size), 4)])
    assert out == [] and eng.telemetry["rejected"] == 1


def test_pool_exhaustion_backpressures_queue(model):
    """A pool of 4 pages (32 positions) against 6 requests wanting about 13
    positions each: admission throttles to what fits, every request still
    completes, and in-use never exceeds the pool."""
    rng = np.random.default_rng(4)
    eng = ContinuousEngine(model, num_slots=3, max_len=32, page_size=8, num_pages=4)
    reqs = [Request(rid=i, prompt=_prompt(rng, 8, model.cfg.vocab_size), max_new_tokens=6)
            for i in range(6)]
    res = eng.run(_requests(reqs))
    assert sorted(r.rid for r in res) == list(range(6))
    assert eng.cache.peak_pages_in_use <= 4
    assert eng.cache.pages_in_use == 0
    assert eng.telemetry["queue_peak"] >= 2
    oracle = _oracle(model, reqs, max_len=32)
    for r in res:
        np.testing.assert_array_equal(r.tokens, oracle[r.rid])


def _seed7_trace(vocab):
    return PoissonLoadGen(rate=0.7, prompt_lens=(4, 8, 12), max_new=(2, 5, 9),
                          vocab_size=vocab, seed=7).trace(12)


def test_continuous_matches_static_oracle_mixed_poisson(model):
    """The headline contract: greedy per-request outputs from the continuous
    engine equal the static engine's (one request at a time) token for token
    on the reference's mixed prompt/budget Poisson trace, while peak paged
    KV stays below the dense batch_size * max_len footprint."""
    trace = _seed7_trace(model.cfg.vocab_size)
    eng = ContinuousEngine(model, num_slots=4, max_len=32, page_size=8)
    res = eng.run_trace([(t, r) for t, r in trace])
    assert len(res) == 12
    oracle = _oracle(model, [r for _, r in trace], max_len=32)
    for r in res:
        np.testing.assert_array_equal(r.tokens, oracle[r.rid], err_msg=f"rid {r.rid}")
    assert eng.cache.peak_pages_in_use * 8 < eng.cache.dense_equivalent_tokens
    stats = eng.latency_stats()
    assert len(stats) == 12
    rep = latency_report(stats, slo_ttft=50.0)
    assert rep["ttft_p50"] >= 0 and rep["ttft_slo_attainment"] > 0
    assert eng.last_wall_s > 0 and eng.now > 0


def test_static_engine_retirement_row_identity(model):
    """Slot retirement (the decode batch shrinks as budgets finish) changes
    no request's tokens, and the work stops at each slot's own budget."""
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=_prompt(rng, 6, model.cfg.vocab_size), max_new_tokens=m)
            for i, m in enumerate((3, 8, 2, 5))]
    eng = ServeEngine(model, batch_size=4, max_len=32)
    out = {r.rid: r.tokens for r in eng.run(_requests(reqs))}
    oracle = _oracle(model, reqs, max_len=32)
    for rid, toks in out.items():
        np.testing.assert_array_equal(toks, oracle[rid])
    assert eng.telemetry["decode_steps"] == 7  # max(effs) - 1
    assert eng.telemetry["slot_steps"] == 14   # sum(effs) - 4, not 4 x 7


@pytest.mark.parametrize("engine, short_len", [("static", 5), ("continuous", 8)])
def test_packing_truncation(model, engine, short_len):
    """Left-pad packing shrinks the short request's admitted budget in the
    static engine (counted), never in the continuous one (unpadded
    prefill)."""
    rng = np.random.default_rng(6)
    long_p = Request(rid=0, prompt=_prompt(rng, 12, model.cfg.vocab_size), max_new_tokens=5)
    short_p = Request(rid=1, prompt=_prompt(rng, 2, model.cfg.vocab_size), max_new_tokens=8)
    eng = (ServeEngine(model, batch_size=2, max_len=16) if engine == "static"
           else ContinuousEngine(model, num_slots=2, max_len=16, page_size=8))
    out = {r.rid: r.tokens for r in eng.run([long_p, short_p])}
    assert out[0].shape == (5,) and out[1].shape == (short_len,)
    if engine == "static":
        assert eng.telemetry["truncated_by_packing"] == 1
        assert eng.telemetry["truncated"] == 0  # admission itself passed


# ---------------------------------------------------------------------------
# the engines against JAX
# ---------------------------------------------------------------------------


def _jax_requests(reqs):
    return [jax_engine.Request(r.rid, np.array(r.prompt), r.max_new_tokens) for r in reqs]


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_engine_tokens_equal_jax_engine(pair, engine):
    jm, jp, pm = pair()
    trace = _seed7_trace(pm.cfg.vocab_size)
    reqs = [r for _, r in trace]
    if engine == "static":  # mixed lengths, left-padded batches of 4
        mine = ServeEngine(pm, batch_size=4, max_len=32).run(_requests(reqs))
        ref = jax_engine.ServeEngine(jm, jp, batch_size=4, max_len=32).run(_jax_requests(reqs))
    else:
        mine = ContinuousEngine(pm, num_slots=4, max_len=32, page_size=8).run_trace(
            [(t, r) for (t, _), r in zip(trace, _requests(reqs))])
        ref = jax_scheduler.ContinuousEngine(jm, jp, num_slots=4, max_len=32,
                                             page_size=8).run_trace(
            [(t, r) for (t, _), r in zip(trace, _jax_requests(reqs))])
    assert [r.rid for r in mine] == [r.rid for r in ref]  # completion order too
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens), err_msg=f"rid {a.rid}")


@pytest.mark.parametrize("strategy", ["fpisa", "fpisa_seq"])
@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_telemetry_through_facade_is_exact(model, engine, strategy):
    rng = np.random.default_rng(8)
    reqs = [Request(rid=i, prompt=_prompt(rng, 5, model.cfg.vocab_size), max_new_tokens=4)
            for i in range(5)]

    def make(agg):
        if engine == "static":
            return ServeEngine(model, batch_size=2, max_len=16, agg=agg)
        return ContinuousEngine(model, num_slots=2, max_len=16, page_size=8, agg=agg)

    plain, agg = make(None), make(AggConfig(strategy=strategy))
    plain.run(_requests(reqs))
    agg.run(_requests(reqs))
    assert agg.aggregator is not None and plain.aggregator is None
    assert agg.aggregator.spec.name == strategy
    assert agg.telemetry_channel.reductions >= 1
    for key in ("requests", "tokens_generated", "decode_steps", "rejected"):
        assert agg.telemetry[key] == plain.telemetry[key], key
    assert agg.telemetry["requests"] == 5 and agg.telemetry["tokens_generated"] == 20


def test_continuous_telemetry_over_shared_multitenant_dataplane(model):
    """The serving engine rides a shared multi-tenant dataplane as tenant 1
    of 2 (tests/test_serve.py's case): its telemetry reductions land on the
    named switch, the totals stay exact, and the switch's per-job counters
    see the serving traffic."""
    from repro_torch import switchsim

    rng = np.random.default_rng(9)
    reqs = [Request(rid=i, prompt=_prompt(rng, 5, model.cfg.vocab_size), max_new_tokens=3)
            for i in range(3)]
    switchsim.reset_shared_dataplanes()
    try:
        plain = ContinuousEngine(model, num_slots=2, max_len=16, page_size=8)
        plain.run(_requests(reqs))
        eng = ContinuousEngine(
            model, num_slots=2, max_len=16, page_size=8,
            agg=AggConfig(strategy="switch_emu", switch_shared="serve-test",
                          switch_jobs=2, switch_job=1))
        eng.run(_requests(reqs))
        assert eng.telemetry["requests"] == 3 and eng.telemetry["tokens_generated"] == 9
        for key in ("requests", "tokens_generated", "decode_steps", "rejected"):
            assert eng.telemetry[key] == plain.telemetry[key], key
        dp = switchsim.shared_dataplane("serve-test", switchsim.DataplaneConfig(
            num_workers=1, num_slots=8, elems_per_packet=256, fmt_name="fp32",
            variant="fpisa_a", num_jobs=2, job_workers=(1, 1)))
        assert dp.job_stats[1]["packets"] > 0  # the serving tenant really used it
        assert dp.job_stats[0]["packets"] == 0
    finally:
        switchsim.reset_shared_dataplanes()


@pytest.mark.parametrize("strategy", ["fpisa", "fpisa_seq", "switchml"])
def test_telemetry_channel_equals_jax_channel(strategy):
    rows = [(1.0, 7.0, 0.0, 0.0), (1.0, 128.0, 0.0, 0.0), (1.0, 1.0, 0.0, 0.0),
            (0.0, 0.0, 311.0, 2.0)]
    mine = TelemetryChannel(AggConfig(strategy=strategy), ncols=4)
    ref = jax_engine.TelemetryChannel(JaxAggConfig(strategy=strategy), ncols=4)
    assert mine.reduce(rows) == ref.reduce(rows) == [3, 136, 311, 2]
    assert mine.reductions == 1


# ---------------------------------------------------------------------------
# load generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(rate=0.5, prompt_lens=(4, 8), max_new=(2, 6), vocab_size=97, seed=11),
    dict(rate=0.7, prompt_lens=(4, 8, 12), max_new=(2, 5, 9), vocab_size=512, seed=7),
    dict(rate=0.5, prompt_lens=(64, 256, 512), max_new=(32, 64, 128), vocab_size=151936,
         seed=0, prompt_weights=(3, 2, 1))])
def test_loadgen_trace_equals_reference(kw):
    a = PoissonLoadGen(**kw).trace(20)
    b = jax_loadgen.PoissonLoadGen(**kw).trace(20)
    assert len(a) == len(b) == 20
    for (ta, ra), (tb, rb) in zip(a, b):
        assert ta == tb and ra.rid == rb.rid and ra.max_new_tokens == rb.max_new_tokens
        np.testing.assert_array_equal(ra.prompt, rb.prompt)
    times = [t for t, _ in a]
    assert times == sorted(times) and times[0] > 0
    assert {len(r.prompt) for _, r in a} <= set(kw["prompt_lens"])
    assert all(r.prompt.max() < kw["vocab_size"] for _, r in a)


def test_loadgen_mean_interarrival_tracks_rate():
    times = [t for t, _ in PoissonLoadGen(rate=2.0, seed=0).trace(600)]
    assert abs(np.diff([0.0] + times).mean() - 0.5) < 0.1  # 1/rate


def test_percentile_and_report_edges():
    assert math.isnan(percentile([], 50))
    assert percentile([1.0, math.nan, 3.0], 50) == 2.0
    rep = latency_report([], slo_ttft=1.0)
    assert math.isnan(rep["ttft_p50"]) and rep["n"] == 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_serve_cli_smoke_on_cpu(engine):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--smoke",
         "--engine", engine, "--agg-strategy", "fpisa"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "6 requests, " in out.stdout
    assert "'requests': 6" in out.stdout and "strategy='fpisa'" in out.stdout
    if engine == "continuous":
        assert "paged KV peak" in out.stdout and "ttft_p50" in out.stdout


def test_serve_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--smoke"])
