"""The port's kernel layer on the CPU: the plain versions of K1
(fused_encode_align), K2 (fused_decode), K3 (extract), K4 (align), K5
(decode) and K6 (accum), reached through repro_torch.kernels.ops with CPU
tensors, must be BIT-IDENTICAL to the JAX package's Pallas kernels
(repro.kernels.ops, run in interpret mode as the JAX suite runs them on the
CPU), and the port's kernels/ref.py to the reference's ref.py called with an
explicit format. The sweep is tests/test_fused_kernels.py's: R in {1, 8,
256, 300, 513}, B in {128, 256, 512}, three formats, int8/int16/int32 decode
inputs, preshift in {0, 2}; K6 at W in {1, 2, 4}, both variants. K6 emits
float32 for every format, as the TPU kernel does (fault F3: the reference's
accum_ref returns the format's dtype). The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fpisa as jf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import fpisa as tf  # noqa: E402
from repro_torch.core import numerics as tnx  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SHAPES = [(1, 256), (8, 128), (256, 256), (300, 512), (513, 128), (64, 512)]
FMTS = ["fp32", "fp16", "bf16"]
JAX_DT = {"fp32": jnp.float32, "fp16": jnp.float16, "bf16": jnp.bfloat16}
VIEW = {"fp32": (np.int32, torch.int32), "fp16": (np.int16, torch.int16),
        "bf16": (np.int16, torch.int16)}
WIRES = {"i8": (np.int8, jnp.int8), "i16": (np.int16, jnp.int16), "i32": (np.int32, jnp.int32)}


def _x(shape, fmt, seed):
    """Gradient-like values with spread exponents, plus +-0, denormals,
    +-inf and NaN, in the format's dtype (as numpy raw bits)."""
    rng = np.random.default_rng(seed)
    span = 4 if fmt == "fp16" else 12
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp2(rng.integers(-span, span, shape)).astype(np.float32)
    flat = x.reshape(-1)
    specials = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-39, -1e-39, 3e-8]
    flat[: min(len(specials), flat.size)] = specials[: flat.size]
    t = torch.from_numpy(x).to(tf.PACKED_DTYPE[fmt])
    return t.view(VIEW[fmt][1]).numpy()


def _pair(raw, fmt):
    return (torch.from_numpy(raw.copy()).view(tf.PACKED_DTYPE[fmt]),
            jnp.asarray(raw).view(JAX_DT[fmt]))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fmt", FMTS)
def test_encode_align_plain_matches_pallas(shape, fmt):
    xt, xj = _pair(_x(shape, fmt, seed=shape[0] + shape[1]), fmt)
    m_t, b_t = tops.encode_align(xt, fmt_name=fmt)
    m_j, b_j = jops.encode_align(xj, fmt_name=fmt)
    assert m_t.dtype == b_t.dtype == torch.int32 and b_t.shape == (shape[0],)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


def _decode_inputs(shape, fmt, wire, seed):
    """Summed mantissas over the wire dtype's whole range (incl. its min, -1,
    0, max) and block exponents from 0 up past the format's exponent range,
    so the renormalize hits zero, underflow, overflow and the carry fix-up."""
    rng = np.random.default_rng(seed)
    npdt = WIRES[wire][0]
    info = np.iinfo(npdt)
    m = rng.integers(info.min, info.max, size=shape, dtype=np.int64, endpoint=True)
    m.reshape(-1)[:4] = [info.min, -1, 0, info.max][: m.size]
    emax = jf.FORMATS[fmt].exp_mask
    bmax = rng.integers(0, emax + 2, size=shape[0]).astype(np.int32)
    return m.astype(npdt), bmax


# every (fmt, wire, preshift) combination, each on one shape of the sweep,
# rotating so that every shape meets every format
DECODE_CASES = [(fmt, wire, pre, SHAPES[(i + 2 * f) % len(SHAPES)])
                for f, fmt in enumerate(FMTS)
                for i, (wire, pre) in enumerate((w, p) for w in WIRES for p in (0, 2))]


@pytest.mark.parametrize("fmt,wire,preshift,shape", DECODE_CASES,
                         ids=[f"{f}-{w}-p{p}-{s[0]}x{s[1]}" for f, w, p, s in DECODE_CASES])
def test_decode_fused_plain_matches_pallas(fmt, wire, preshift, shape):
    m, bmax = _decode_inputs(shape, fmt, wire, seed=preshift * 7 + shape[0])
    out_t = tops.decode_fused(torch.from_numpy(m), torch.from_numpy(bmax),
                              preshift=preshift, fmt_name=fmt)
    out_j = jops.decode_fused(jnp.asarray(m), jnp.asarray(bmax), preshift=preshift,
                              fmt_name=fmt)
    npdt, tdt = VIEW[fmt]
    assert out_t.dtype == tf.PACKED_DTYPE[fmt] and out_t.shape == shape
    np.testing.assert_array_equal(out_t.view(tdt).numpy(), np.asarray(out_j).view(npdt))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("preshift", [0, 2])
def test_local_align_plus_residual_shift_equals_two_pass(shape, preshift):
    """The aggregation's composition: plain K1 (local block max) followed by
    the residual arshift to a cross-worker exponent equals the reference's
    extract_ref -> align_ref against that exponent directly."""
    fmt = "fp32"
    xt, xj = _pair(_x(shape, fmt, seed=11 + shape[0]), fmt)
    exp, man, bmax = jax.jit(jref.extract_ref)(xj)
    bump = np.random.default_rng(shape[0]).integers(0, 4, shape[0]).astype(np.int32)
    direct = jax.jit(jref.align_ref, static_argnums=3)(exp, man, bmax + jnp.asarray(bump),
                                                      preshift)

    m_local, b_local = tops.encode_align(xt, fmt_name=fmt)
    global_bmax = b_local + torch.from_numpy(bump)
    composed = tnx.arshift(m_local, (global_bmax - b_local)[:, None] + preshift)
    np.testing.assert_array_equal(composed.numpy(), np.asarray(direct))


def test_wrappers_check_their_inputs():
    x = torch.zeros((4, 256), dtype=torch.float16)
    for fn in (tops.encode_align, tops.extract):
        with pytest.raises(ValueError, match="fmt_name='fp32' takes"):
            fn(x, fmt_name="fp32")
        with pytest.raises(ValueError, match=r"\(R, B\) plane"):
            fn(torch.zeros(256), fmt_name="fp32")
    with pytest.raises(ValueError, match=r"\(W, R, B\) stack"):
        tops.accum(torch.zeros((2, 4, 256), dtype=torch.float16), fmt_name="fp32")
    with pytest.raises(ValueError, match=r"\(W, R, B\) stack"):
        tops.accum(torch.zeros((4, 256)), fmt_name="fp32")


def _all_launches():
    return tuple(f.launches for f in (tops.encode_align, tops.decode_fused, tops.extract,
                                      tops.align, tops.decode, tops.accum))


def test_launch_counters_count_only_kernel_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    before = _all_launches()
    m, b = tops.encode_align(torch.ones((2, 128)), fmt_name="fp32")
    tops.decode_fused(m, b, 0, "fp32")
    e, m, b = tops.extract(torch.ones((2, 128)), fmt_name="fp32")
    tops.decode(tops.align(e, m, b, 0), b, 0, "fp32")
    tops.accum(torch.ones((3, 2, 128)), "fpisa_a", "fp32")
    assert _all_launches() == before


# ---------------------------------------------------------------------------
# K3-K6: the two-pass pipeline and the switch-arrival accumulation
# ---------------------------------------------------------------------------


def _raw(shape, fmt, seed):
    """Raw bit patterns of the format in every other row (every exponent,
    both signs, denormals; inf/NaN patterns become +-inf, whose bits no
    framework rewrites), gradient-like values with spread exponents in the
    rest, and the special values up front; as numpy raw bits."""
    rng = np.random.default_rng(seed)
    npdt = VIEW[fmt][0]
    bits = rng.integers(np.iinfo(npdt).min, np.iinfo(npdt).max, size=shape,
                        dtype=np.int64, endpoint=True).astype(npdt)
    f = jf.FORMATS[fmt]
    special = ((bits.astype(np.int64) >> f.man_bits) & f.exp_mask) == f.exp_mask
    bits = np.where(special, bits & ~npdt(f.man_mask), bits).astype(npdt)
    grad = _x(shape, fmt, seed)
    rows = np.arange(shape[-2])[:, None] % 2 == 1
    return np.where(rows, grad, bits).astype(npdt)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fmt", FMTS)
def test_extract_plain_matches_pallas(shape, fmt):
    xt, xj = _pair(_raw(shape, fmt, seed=shape[0] * 5 + shape[1]), fmt)
    got = tops.extract(xt, fmt_name=fmt)
    pallas = jops.extract(xj, fmt_name=fmt)
    oracle = jref.extract_ref(xj, jf.FORMATS[fmt])
    assert [t.dtype for t in got] == [torch.int32] * 3 and got[2].shape == (shape[0],)
    for g, p, o in zip(got, pallas, oracle):
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
        np.testing.assert_array_equal(g.numpy(), np.asarray(o))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("preshift", [0, 2])
def test_align_plain_matches_pallas(shape, preshift):
    """Aligned to block exponents raised past the local max (a cross-worker
    MAX), so shifts run from 0 to past 31."""
    fmt = FMTS[shape[0] % 3]
    xt, xj = _pair(_raw(shape, fmt, seed=shape[1] + preshift), fmt)
    exp, man, bmax = tref.extract_ref(xt, tf.FORMATS[fmt])
    bump = np.random.default_rng(shape[0]).integers(0, 40, shape[0]).astype(np.int32)
    bmax = bmax + torch.from_numpy(bump)
    got = tops.align(exp, man, bmax, preshift)
    ej, mj, bj = (jnp.asarray(t.numpy()) for t in (exp, man, bmax))
    assert got.dtype == torch.int32 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.align(ej, mj, bj, preshift)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.align_ref(ej, mj, bj, preshift)))


DECODE32_CASES = [(fmt, pre, SHAPES[(2 * f + p) % len(SHAPES)])
                  for f, fmt in enumerate(FMTS) for p, pre in enumerate((0, 2))]


@pytest.mark.parametrize("fmt,preshift,shape", DECODE32_CASES,
                         ids=[f"{f}-p{p}-{s[0]}x{s[1]}" for f, p, s in DECODE32_CASES])
def test_decode_plain_matches_pallas(fmt, preshift, shape):
    """int32 sums over the whole range, block exponents from 0 to past the
    format's range; against the Pallas kernel and the reference's
    decode_ref with the format passed explicitly (its ops.decode with
    use_pallas=False would drop it: F3)."""
    m, bmax = _decode_inputs(shape, fmt, "i32", seed=preshift * 11 + shape[0])
    out = tops.decode(torch.from_numpy(m), torch.from_numpy(bmax), preshift, fmt)
    pallas = jops.decode(jnp.asarray(m), jnp.asarray(bmax), preshift=preshift, fmt_name=fmt)
    oracle = jref.decode_ref(jnp.asarray(m), jnp.asarray(bmax), preshift, jf.FORMATS[fmt])
    npdt, tdt = VIEW[fmt]
    assert out.dtype == tf.PACKED_DTYPE[fmt] and out.shape == shape
    assert np.asarray(pallas).dtype == np.asarray(oracle).dtype == JAX_DT[fmt]
    np.testing.assert_array_equal(out.view(tdt).numpy(), np.asarray(pallas).view(npdt))
    np.testing.assert_array_equal(out.view(tdt).numpy(), np.asarray(oracle).view(npdt))


ACCUM_CASES = [(w, v, f) for w in (1, 2, 4) for v in ("fpisa_a", "full") for f in FMTS]


@pytest.mark.parametrize("world,variant,fmt", ACCUM_CASES,
                         ids=[f"W{w}-{v}-{f}" for w, v, f in ACCUM_CASES])
def test_accum_plain_matches_pallas(world, variant, fmt):
    """ops.accum (plain K6 on the CPU) emits float32 and equals the Pallas
    kernel's float32 bit for bit; ref.accum_ref keeps the format's dtype and
    equals the reference's accum_ref with the format passed explicitly. The
    raw-bit rows make FPISA-A overwrite (d > headroom), left-shift into the
    headroom and wrap the int32 register."""
    shape = (world, 16, 256)
    raw = _raw(shape, fmt, seed=100 * world + len(variant))
    # row 0, columns 0..4: the largest mantissa at exponent = headroom from
    # every worker: each is left-shifted by the full headroom into the
    # exponent-0 accumulator, and the second one wraps the int32 register;
    # column 4 from worker 1 at headroom + 1: it overwrites the accumulator
    f = jf.FORMATS[fmt]
    top = lambda e: np.array((e << f.man_bits) | f.man_mask).astype(VIEW[fmt][0])  # noqa: E731
    raw[:, 0, :5] = top(f.headroom)
    raw[1:2, 0, 4] = top(f.headroom + 1)
    xt, xj = _pair(raw, fmt)
    got = tops.accum(xt, variant, fmt)
    pallas = np.asarray(jops.accum(xj, variant=variant, fmt_name=fmt))
    assert got.dtype == torch.float32 and pallas.dtype == np.float32
    assert got.shape == shape[1:]
    np.testing.assert_array_equal(got.view(torch.int32).numpy(), pallas.view(np.int32))
    plain = tref.accum_ref(xt, variant, tf.FORMATS[fmt])
    oracle = np.asarray(jref.accum_ref(xj, variant, jf.FORMATS[fmt]))
    npdt, tdt = VIEW[fmt]
    assert plain.dtype == tf.PACKED_DTYPE[fmt] and oracle.dtype == JAX_DT[fmt]
    np.testing.assert_array_equal(plain.view(tdt).numpy(), oracle.view(npdt))
    assert torch.equal(plain.to(torch.float32), got)
    if variant == "fpisa_a" and world > 1:
        _, st = tf.fpisa_sum_sequential(xt, tf.FORMATS[fmt], variant, return_stats=True)
        assert int(st["overwrite"]) > 0 and int(st["overflow"]) > 0


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("preshift", [0, 2])
def test_two_pass_equals_fused(fmt, preshift):
    """decode(align(extract(x))) == decode_fused(residual shift of
    encode_align(x)), as the reference's roofline benchmark holds the two
    forms (preshift applied as the residual shift on the fused side)."""
    xt, _ = _pair(_raw((300, 256), fmt, seed=7 + preshift), fmt)
    exp, man, bmax = tops.extract(xt, fmt)
    two = tops.decode(tops.align(exp, man, bmax, preshift), bmax, preshift, fmt)
    m_local, b_local = tops.encode_align(xt, fmt)
    fused = tops.decode_fused(tnx.arshift(m_local, preshift), b_local, preshift, fmt)
    assert torch.equal(two.view(VIEW[fmt][1]), fused.view(VIEW[fmt][1]))
