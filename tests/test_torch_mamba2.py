"""The port's Mamba2 / SSD block (repro_torch.models.mamba2) and the ssm and
hybrid families against the JAX reference, at smoke size, on the same
weights and inputs (numpy seeds).

* ``_segsum`` and the causal conv: within 1e-6 of their largest |entry|.
  ``ssd_chunked`` at 1, 2 and 4 chunks and at a chunk that does not divide
  the sequence (halved until it does: 24 -> 1 at 64 tokens): y and the
  final state within 1e-5 of their largest |entry|.
* ``apply_mamba2``: train mode (output, final SSM state, conv state) and
  the one-step decode recurrence with its conv state, within 1e-5; and the
  recurrence continues a prefill: prefill of S tokens then one decode step
  equals the chunked scan over S + 1 tokens, within 1e-5.
* mamba2-780m and zamba2-7b (one shared attention block after each group of
  mamba blocks, tail blocks after) at smoke size: forward, loss and
  gradients; prefill and decode with the SSM and conv states and the
  hybrid's K/V (torch_model_parity.py's tolerances).
* The static engine's greedy tokens equal the reference engine's, with
  mixed prompt lengths (the left pads run through the recurrence, F6).
* The continuous engine, the paged KV cache and paged decode refuse both
  families with the reference's errors.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba2 as jm2  # noqa: E402
from repro.models.layers import AxesRecorder  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.kvcache import PagedKVCache  # noqa: E402
from repro_torch.serve.scheduler import ContinuousEngine  # noqa: E402
from torch_model_parity import (check_forward_and_grads, check_prefill_and_decode,  # noqa: E402
                                make_batch, np_, pair)

ARCHS = ["mamba2-780m", "zamba2-7b"]
TOL = 1e-5


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got if isinstance(got, np.ndarray) else np_(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def test_segsum_and_causal_conv_match_the_reference():
    rng = np.random.default_rng(0)
    da = -np.abs(rng.standard_normal((2, 3, 16))).astype(np.float32)
    want = np.asarray(jm2._segsum(jnp.asarray(da)))
    got = np_(tm2._segsum(torch.from_numpy(da)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], tol=1e-6)
    xbc = rng.standard_normal((2, 10, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = jm2._causal_conv_train(*map(jnp.asarray, (xbc, w, b)))
    got = tm2._causal_conv_train(*map(torch.from_numpy, (xbc, w, b)))
    _close(got, want, tol=1e-6)


def _ssd_inputs(seed, s=64, h=4, p=8, g=2, n=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, s, h, p)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((2, s, h)))).astype(np.float32),
            -np.exp(rng.standard_normal(h)).astype(np.float32),
            rng.standard_normal((2, s, g, n)).astype(np.float32),
            rng.standard_normal((2, s, g, n)).astype(np.float32),
            rng.standard_normal(h).astype(np.float32))


@pytest.mark.parametrize("chunk", [64, 32, 16, 24])
def test_ssd_chunked_matches_the_reference(chunk):
    args = _ssd_inputs(1)
    y, state = jm2.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    ty, tstate = tm2.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    _close(ty, y)
    _close(tstate, state)
    assert tm2.chunk_len(64, chunk) == {64: 64, 32: 32, 16: 16, 24: 1}[chunk]


def _block(arch, seed):
    cfg = get_smoke_config(arch)
    p = jm2.init_mamba2(jax.random.PRNGKey(seed), cfg, AxesRecorder(), "mamba")
    p = {k: np.asarray(v).copy() for k, v in p.items()}
    p["dt_bias"] = np.random.default_rng(seed).standard_normal(p["dt_bias"].shape).astype(
        np.float32)  # a non-trivial dt (the init is zeros)
    return cfg, {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.from_numpy(v)
                                                          for k, v in p.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_mamba2_train_and_decode_match_the_reference(arch):
    cfg, jp, tp = _block(arch, 2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    y, s, c = jm2.apply_mamba2(jp, jnp.asarray(x), cfg)
    ty, ts, tc = tm2.apply_mamba2(tp, torch.from_numpy(x), cfg)
    for got, want in ((ty, y), (ts, s), (tc, c)):
        _close(got, want)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    y1, s1, c1 = jm2.apply_mamba2(jp, jnp.asarray(x1), cfg, s, c, decode=True)
    ty1, ts1, tc1 = tm2.apply_mamba2(tp, torch.from_numpy(x1), cfg, ts, tc, decode=True)
    for got, want in ((ty1, y1), (ts1, s1), (tc1, c1)):
        _close(got, want)
    # the recurrence continues the chunked scan
    full, fs, _ = tm2.apply_mamba2(tp, torch.from_numpy(np.concatenate([x, x1], 1)), cfg)
    _close(ty1, np_(full[:, -1:]))
    _close(ts1, np_(fs))
    s0, c0 = tm2.init_ssm_state(3, cfg)
    assert s0.shape == (3, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    assert s0.dtype == torch.float32 and not s0.any()
    assert c0.shape == (3, cfg.ssm_conv_width - 1,
                        cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_model_matches_the_reference(arch):
    jm, jp, pm = pair(arch)
    check_forward_and_grads(jm, jp, pm, make_batch(pm.cfg, 2, 64, seed=4))
    check_prefill_and_decode(jm, jp, pm, make_batch(pm.cfg, 2, 64, seed=5), max_len=80,
                             steps=3)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_engine_tokens_equal_the_reference_engine(arch):
    jm, jp, pm = pair(arch)
    rng = np.random.default_rng(6)
    reqs = [(i, rng.integers(0, pm.cfg.vocab_size, n).astype(np.int32), m)
            for i, (n, m) in enumerate([(5, 6), (12, 4), (8, 7), (12, 3), (6, 5)])]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_engine.ServeEngine(jm, jp, batch_size=3, max_len=24).run(
            [jax_engine.Request(i, p, m) for i, p, m in reqs])
        got = ServeEngine(pm, batch_size=3, max_len=24).run([Request(i, p, m)
                                                              for i, p, m in reqs])
    assert [r.rid for r in got] == [r.rid for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=f"rid {a.rid}")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serving_refuses_ssm_and_hybrid(arch):
    pm = pair(arch)[2]
    with pytest.raises(ValueError, match=f"model family '{pm.cfg.family}' has no paged "
                                         "decode path; use the static ServeEngine"):
        ContinuousEngine(pm, num_slots=2, max_len=16, page_size=8)
    with pytest.raises(ValueError, match="paged KV serving supports attention-KV families"):
        PagedKVCache(pm.cfg, num_slots=2, max_len=16, page_size=8)
    with pytest.raises(ValueError, match="use the static engine for ssm/hybrid"):
        pm.decode_step_paged(*(torch.zeros((2, 1), dtype=torch.long),) * 3,
                             torch.zeros((2, 2), dtype=torch.long),
                             torch.zeros(2, dtype=torch.long))
