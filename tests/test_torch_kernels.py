"""The port's kernel layer on the CPU: the plain versions of K1
(fused_encode_align) and K2 (fused_decode), reached through
repro_torch.kernels.ops with CPU tensors, must be BIT-IDENTICAL to the JAX
package's Pallas kernels (repro.kernels.ops, run in interpret mode as the
JAX suite runs them on the CPU). The sweep is tests/test_fused_kernels.py's:
R in {1, 8, 256, 300, 513}, B in {128, 256, 512}, three formats, int8/int16/
int32 decode inputs, preshift in {0, 2}. The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py,
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
    with pytest.raises(ValueError, match="fmt_name='fp32' takes"):
        tops.encode_align(x, fmt_name="fp32")
    with pytest.raises(ValueError, match=r"\(R, B\) plane"):
        tops.encode_align(torch.zeros(256), fmt_name="fp32")


def test_launch_counters_count_only_kernel_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    before = (tops.encode_align.launches, tops.decode_fused.launches)
    m, b = tops.encode_align(torch.ones((2, 128)), fmt_name="fp32")
    tops.decode_fused(m, b, 0, "fp32")
    assert (tops.encode_align.launches, tops.decode_fused.launches) == before
