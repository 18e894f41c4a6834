"""The port's Mamba2 / SSD block (repro_torch.models.mamba2) and the ssm and
hybrid families against the JAX reference, at smoke size, on the same
weights and inputs (numpy seeds).

* ``_segsum`` and the causal conv: within 1e-6 of their largest |entry|.
  ``ssd_chunked`` at 1, 2 and 4 chunks and at a chunk that does not divide
  the sequence (halved until it does: 24 -> 1 at 64 tokens): y and the
  final state within 1e-5 of their largest |entry|.
* ``kernels/ssd.py::ssd_backward_ref`` (S1's backward algebra written in
  torch) against autograd of ``ssd_chunked_ref``: dx, ddt, dA, dB, dC and
  dD within 1e-5 of each gradient's largest |entry|, at 1, 2 and 4 chunks
  and at a chunk that halves to 1, in float64 and float32.
* S1's CUDA source (``csrc/ssd_chunked.cu``) built with the host's C++
  compiler against ``tests/ssd_host_emu.h`` and run on CPU memory: y, the
  final state and every gradient against the float64 plain version, within
  1e-5 of their largest |entry| (y, dx, dB, dC in bf16: 2^-8), at a full
  and a masked 64-row tile, two chunks, N 128, grouped heads and strided
  views.
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
import ctypes
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba2 as jm2  # noqa: E402
from repro.models.layers import AxesRecorder  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ssd as tssd  # noqa: E402
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("chunk", [64, 32, 16, 24])
def test_ssd_backward_ref_is_the_gradient(chunk, dtype):
    args = [torch.from_numpy(t).to(dtype).requires_grad_() for t in _ssd_inputs(4)]
    y, fin = tssd.ssd_chunked_ref(*args, chunk)
    rng = np.random.default_rng(5)
    dy = torch.from_numpy(rng.standard_normal(y.shape)).to(dtype)
    dfin = torch.from_numpy(rng.standard_normal(fin.shape)).to(dtype)
    want = torch.autograd.grad((y * dy).sum() + (fin * dfin).sum(), args)
    got = tssd.ssd_backward_ref(*[t.detach() for t in args], chunk, dy, dfin)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g.detach(), w.detach().numpy())


# --- S1's CUDA source on the host ----------------------------------------

CSRC = Path(tssd.__file__).resolve().parent.parent / "csrc" / "ssd_chunked.cu"
_L, _P = ctypes.c_longlong, ctypes.c_void_p


@pytest.fixture(scope="module")
def s1_host(tmp_path_factory):
    """csrc/ssd_chunked.cu built with the host's C++ compiler over the
    emulation header."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler builds S1's source"
    out = tmp_path_factory.mktemp("s1") / "libssd_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-DSSD_HOST_EMU",
                    "-include", str(Path(__file__).with_name("ssd_host_emu.h")), "-x", "c++",
                    str(CSRC), "-o", str(out), "-lpthread"], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.ssd_chunked_fwd.argtypes = [ctypes.c_int, _P, _L, _L, _P, _P, _P, _L, _L, _P, _L, _L,
                                    _P, _P, _P, _P] + [ctypes.c_int] * 8 + [_P]
    lib.ssd_chunked_bwd.argtypes = [ctypes.c_int, _P, _L, _L, _P, _P, _P, _L, _L, _P, _L, _L,
                                    _P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P] + \
        [ctypes.c_int] * 8 + [_P]
    lib.ssd_chunked_workspace.argtypes = [ctypes.c_int] * 8
    lib.ssd_chunked_workspace.restype = _L
    return lib


def _host_s1(lib, x, dt, a, bm, cm, d, chunk, dy, dfin):
    """S1's forward and backward through the host build, as
    ``kernels/ssd.py`` launches them: -> (y, final, (dx, ddt, da, dB, dC, dD))."""
    b, s, h, p = x.shape
    g, n = bm.shape[2:]
    q, hb = tssd.chunk_len(s, chunk), tssd.heads_per_cta(h // g)
    code = tssd.DTYPE_CODES[x.dtype]
    y, fin = torch.empty(b, s, h, p, dtype=x.dtype), torch.empty(b, h, p, n)
    ent = torch.empty(b, s // q, h, p, n)
    dims = (b, s, h, p, g, n, q, hb)
    ins = (x.data_ptr(), x.stride(0), x.stride(1), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
           bm.stride(0), bm.stride(1), cm.data_ptr(), cm.stride(0), cm.stride(1), d.data_ptr())
    assert lib.ssd_chunked_fwd(code, *ins, y.data_ptr(), fin.data_ptr(), ent.data_ptr(), *dims,
                               None) == 0
    grads = (torch.empty_like(y), torch.empty(b, s, h), torch.empty(h),
             torch.empty(b, s, g, n, dtype=x.dtype), torch.empty(b, s, g, n, dtype=x.dtype),
             torch.empty(h))
    work = torch.full((lib.ssd_chunked_workspace(*dims),), float("nan"))
    dx, ddt, da, db, dc, dd = grads
    assert lib.ssd_chunked_bwd(code, *ins, dy.data_ptr(), dy.stride(0), dy.stride(1),
                               dfin.data_ptr(), ent.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                               da.data_ptr(), db.data_ptr(), dc.data_ptr(), dd.data_ptr(),
                               work.data_ptr(), *dims, None) == 0
    return y, fin, grads


# (B, S, H, P, G, N, chunk, dtype): two chunks of two full 64-row tiles with
# grouped heads; one chunk of a full and a masked tile at N 128; 16-row
# chunks of 3 heads; a whole 256-row chunk in bf16
S1_HOST_CASES = [(2, 256, 4, 16, 2, 16, 128, torch.float32),
                 (1, 96, 2, 16, 1, 128, 96, torch.float32),
                 (1, 48, 3, 8, 1, 16, 16, torch.float32),
                 (1, 256, 2, 64, 1, 32, 256, torch.bfloat16)]


@pytest.mark.parametrize("case", S1_HOST_CASES, ids=lambda c: "x".join(map(str, c[:7])))
def test_s1_source_on_the_host(s1_host, case):
    b, s, h, p, g, n, chunk, dtype = case
    gen = torch.Generator().manual_seed(sum(case[:7]))
    wide = torch.randn(b, s, h * p + 2 * g * n + 8, generator=gen).to(dtype)
    x = wide[..., :h * p].unflatten(-1, (h, p))
    bm = wide[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cm = wide[..., h * p + g * n:h * p + 2 * g * n].unflatten(-1, (g, n))
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen))
    a = -torch.exp(torch.randn(h, generator=gen))
    d = torch.randn(h, generator=gen)
    dy = torch.randn(b, s, h, p, generator=gen).to(dtype)
    dfin = torch.randn(b, h, p, n, generator=gen)
    y, fin, got = _host_s1(s1_host, x, dt, a, bm, cm, d, chunk, dy, dfin)
    ref = [t.double().requires_grad_() for t in (x, dt, a, bm, cm, d)]
    yr, fr = tssd.ssd_chunked_ref(*ref, chunk)
    want = torch.autograd.grad((yr * dy.double()).sum() + (fr * dfin.double()).sum(), ref)
    loose = 2.0 ** -8 if dtype == torch.bfloat16 else TOL
    for name, tol, g_, w in zip(("y", "final", "dx", "ddt", "dA", "dB", "dC", "dD"),
                                (loose, TOL, loose, TOL, TOL, loose, loose, TOL),
                                (y, fin, *got), (yr, fr, *want)):
        err = float((g_.double() - w.detach()).abs().max() / w.detach().abs().max())
        assert err <= tol, f"{name}: {err:.3e} of the largest |entry| (limit {tol:.1e})"


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
