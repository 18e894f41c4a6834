"""Bit-level core of the port (repro_torch.core.numerics / fpisa) against the
JAX reference (repro.core.numerics / fpisa): every result must be
BIT-IDENTICAL, compared on integer views, over fp32/fp16/bf16 including
+-0, denormals, +-inf, NaN, int32-min mantissas and exponent over/underflow.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import fpisa as jf  # noqa: E402
from repro.core import numerics as jnx  # noqa: E402
from repro_torch.core import fpisa as tf  # noqa: E402
from repro_torch.core import numerics as tnx  # noqa: E402

FMTS = ["fp32", "fp16", "bf16"]
NBITS = {"fp32": 32, "fp16": 16, "bf16": 16}
INT_VIEW = {32: (np.int32, torch.int32), 16: (np.int16, torch.int16)}
JAX_DT = {"fp32": jnp.float32, "fp16": jnp.float16, "bf16": jnp.bfloat16}


def _special_bits(fmt):
    """+-0, smallest/largest denormal, +-inf, quiet/signalling NaN, largest
    finite, smallest normal — as raw bit patterns of the format."""
    f = jf.FORMATS[fmt]
    sign = 1 << (f.total_bits - 1)
    inf = f.exp_mask << f.man_bits
    pos = [0, 1, f.man_mask, inf, inf | 1, inf | f.man_mask,
           inf - 1, 1 << f.man_bits]
    return pos + [p | sign for p in pos]


def _raw(fmt, shape, seed):
    """Random raw bit patterns (hit every exponent, inf and NaN) with the
    special values in front, as a signed integer array of the format's width."""
    n = NBITS[fmt]
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << n, size=shape, dtype=np.uint64)
    sp = np.asarray(_special_bits(fmt), np.uint64)
    raw.reshape(-1)[: sp.size] = sp
    return raw.astype(np.uint32 if n == 32 else np.uint16).view(INT_VIEW[n][0])


def _both(fmt, raw):
    xt = torch.from_numpy(raw.copy()).view(tf.PACKED_DTYPE[fmt])
    xj = jnp.asarray(raw).view(JAX_DT[fmt])
    return xt, xj


def _bits(out_t, out_j, fmt):
    npdt, tdt = INT_VIEW[NBITS[fmt]]
    return out_t.view(tdt).numpy(), np.asarray(out_j).view(npdt)


@pytest.mark.parametrize("fmt", FMTS)
def test_encode_bit_identical(fmt):
    xt, xj = _both(fmt, _raw(fmt, (4096,), seed=1))
    pt, pj = tf.encode(xt, tf.FORMATS[fmt]), jf.encode(xj, jf.FORMATS[fmt])
    assert pt.exp.dtype == pt.man.dtype == torch.int32
    np.testing.assert_array_equal(pt.exp.numpy(), np.asarray(pj.exp))
    np.testing.assert_array_equal(pt.man.numpy(), np.asarray(pj.man))


def _planes(fmt, n, seed):
    """Exponents across the whole range (under/overflow after the shift) and
    int32 mantissas including int32-min, +-1, 0 and int32-max."""
    f = jf.FORMATS[fmt]
    rng = np.random.default_rng(seed)
    e = rng.integers(-4, f.exp_mask + 8, size=n).astype(np.int32)
    m = rng.integers(-2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
    small = rng.integers(-(1 << (f.man_bits + 3)), 1 << (f.man_bits + 3), size=n // 2)
    m[: n // 2] = small.astype(np.int32)
    m[:6] = [-2**31, -1, 0, 1, 2**31 - 1, -(1 << (f.man_bits + 1))]
    e[:6] = [f.exp_mask - 1, 1, 200 % f.exp_mask, 0, f.exp_mask + 3, -2]
    return e, m


@pytest.mark.parametrize("fmt", FMTS)
def test_renormalize_bit_identical(fmt):
    e, m = _planes(fmt, 4096, seed=2)
    out_t = tf.renormalize(tf.Planes(torch.from_numpy(e), torch.from_numpy(m)), tf.FORMATS[fmt])
    out_j = jf.renormalize(jf.Planes(jnp.asarray(e), jnp.asarray(m)), jf.FORMATS[fmt])
    assert out_t.dtype == tf.PACKED_DTYPE[fmt]
    bt, bj = _bits(out_t, out_j, fmt)
    np.testing.assert_array_equal(bt, bj)
    # the edge classes were really exercised: inf, zero, a flushed underflow
    f = jf.FORMATS[fmt]
    expo = (bj.astype(np.int64) >> f.man_bits) & f.exp_mask
    assert (expo == f.exp_mask).any() and (bj == 0).any() and (expo == 0).sum() > 1


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("preshift", [0, 3])
def test_block_encode_decode_bit_identical(fmt, preshift):
    block = 128
    xt, xj = _both(fmt, _raw(fmt, (8 * block,), seed=3))
    f_t, f_j = tf.FORMATS[fmt], jf.FORMATS[fmt]
    be_t = tf.block_max_exponent(tf.encode(xt, f_t).exp, block)
    be_j = jf.block_max_exponent(jf.encode(xj, f_j).exp, block)
    np.testing.assert_array_equal(be_t.numpy(), np.asarray(be_j))
    # a cross-worker max above the local one
    bump = np.random.default_rng(4).integers(0, 3, be_t.shape).astype(np.int32)
    gt, gj = be_t + torch.from_numpy(bump), be_j + jnp.asarray(bump)
    man_t = tf.block_encode(xt, gt, block, preshift, f_t)
    man_j = jf.block_encode(xj, gj, block, preshift, f_j)
    np.testing.assert_array_equal(man_t.numpy(), np.asarray(man_j))
    # a two-worker sum decodes identically
    out_t = tf.block_decode(man_t * 2, gt, block, preshift, f_t)
    out_j = jf.block_decode(man_j * 2, gj, block, preshift, f_j)
    np.testing.assert_array_equal(*_bits(out_t, out_j, fmt))


def test_clz32_bit_identical():
    rng = np.random.default_rng(5)
    x = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64).astype(np.int32)
    x[:41] = [0, 1, -1, -2**31, 2**31 - 1] + [1 << k for k in range(31)] + [3, 5, 7, 255, 256]
    x[41:1041] >>= rng.integers(0, 32, size=1000).astype(np.int32)  # every width
    got = tnx.clz32(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnx.clz32(jnp.asarray(x))))
    np.testing.assert_array_equal(tnx.floor_log2_u32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnx.floor_log2_u32(jnp.asarray(x))))


@pytest.mark.parametrize("op", ["arshift", "lshift"])
def test_shifts_bit_identical_at_every_distance(op):
    rng = np.random.default_rng(6)
    dist = np.arange(-5, 41, dtype=np.int32)
    x = rng.integers(-2**31, 2**31, size=(64, 1), dtype=np.int64).astype(np.int32)
    x[:4, 0] = [-2**31, -1, 2**31 - 1, 0]
    xs, ds = np.broadcast_arrays(x, dist[None, :])
    got = getattr(tnx, op)(torch.from_numpy(xs.copy()), torch.from_numpy(ds.copy()))
    want = getattr(jnx, op)(jnp.asarray(xs), jnp.asarray(ds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # scalar distances too (the residual shift passes Python ints)
    for d in (-3, 0, 7, 31, 32, 40):
        np.testing.assert_array_equal(
            getattr(tnx, op)(torch.from_numpy(x), d).numpy(),
            np.asarray(getattr(jnx, op)(jnp.asarray(x), d)))


def test_required_preshift_matches():
    for fmt in FMTS:
        for w in [0, 1, 2, 3, 64, 127, 128, 129, 1000, 2**20]:
            assert tnx.required_preshift(w, tf.FORMATS[fmt]) == \
                jnx.required_preshift(w, jf.FORMATS[fmt])
    assert {n: (f.bias, f.headroom, f.total_bits) for n, f in tnx.FORMATS.items()} == \
        {n: (f.bias, f.headroom, f.total_bits) for n, f in jnx.FORMATS.items()}
