"""K1's exponent and wire modes and K2's leaf-dtype output on the CPU.

The aggregation on the port's ``cuda`` backend runs K1's exponent mode
(``ops.block_max``: the block max exponent over a (k, R, B) leaf stack), the
MAX all-reduce, K1's wire mode (``ops.encode_wire``: one shift to the agreed
exponent, the wire cast, the int32 fold over the k workers) and K2 in the
leaf's dtype (``ops.decode_fused(..., out_dtype)``). Here CPU tensors take
their plain versions (``kernels/ref.py``), which must be BIT-EQUAL to the
JAX reference's composition: ``repro.core.fpisa.encode``, then
``repro.core.numerics.arshift`` to the block exponent of the (k, R, B) stack,
the wire cast and the int32 sum, then ``block_decode(...).astype(leaf
dtype)``. Formats fp32/fp16/bf16, wires 32/16/8, leaf dtypes fp32/bf16/fp16
where the widening is exact, k in {1, 4}, blocks 128/256/512, the
non-finite words of tests/test_torch_nonfinite.py and the range edges, and
shift distances from -5 to 43. K2 to every output dtype of every format.

The header's per-element arithmetic (``csrc/fpisa_fused.cuh``: widen,
exp_field and block_exp, encode, arshift, to_wire, renormalize, cast_to) is
compiled with the host's
g++ into the same three passes and held to the plain versions. And the
``cuda`` branch of ``core/allreduce.py`` (``_encode_align``,
``_encode_align_stacked``, ``_decode``, and the whole flat, stacked and
hierarchical paths), driven with CPU tensors so that ``ops`` takes the plain
versions, must equal the ``torch`` branch bit for bit.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import fpisa as jf  # noqa: E402
from repro.core import numerics as jnx  # noqa: E402
from repro_torch.core import allreduce as tar  # noqa: E402
from repro_torch.core import fpisa as tf  # noqa: E402
from repro_torch.core.agg import AggConfig  # noqa: E402
from repro_torch.kernels import fpisa_fused, ops, ref  # noqa: E402
from test_torch_nonfinite import BF16_SPECIALS, F32_SPECIALS  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
FMTS = ["fp32", "fp16", "bf16"]
TDT = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}
JDT = {"fp32": jnp.float32, "fp16": jnp.float16, "bf16": jnp.bfloat16}
INT = {"fp32": (np.int32, torch.int32), "fp16": (np.int16, torch.int16),
       "bf16": (np.int16, torch.int16)}
WIRE_NP = {32: np.int32, 16: np.int16, 8: np.int8}
# (format, leaf dtype) pairs the new K1 modes read as they are
PAIRS = [("fp32", "fp32"), ("fp32", "bf16"), ("fp32", "fp16"), ("fp16", "fp16"),
         ("bf16", "bf16")]
FP16_SPECIALS = np.array([0x7C00, 0xFC00, 0x7E00, 0xFE00, 0x7C01, 0xFC01, 0x7BFF, 0xFBFF,
                          0x0001, 0x83FF, 0x0400, 0x8400], np.uint16)
# range edges per leaf dtype: largest finite, smallest normal, denormals
EDGES = {"fp32": np.array([0x7F7FFFFF, 0xFF7FFFFF, 0x00800000, 0x80800000, 0x00000001,
                           0x807FFFFF, 0x80000000], np.uint32),
         "bf16": np.array([0x7F7F, 0xFF7F, 0x0080, 0x8080, 0x0001, 0x807F, 0x8000],
                          np.uint16),
         "fp16": FP16_SPECIALS}
SPECIALS = {"fp32": F32_SPECIALS, "bf16": BF16_SPECIALS, "fp16": FP16_SPECIALS}
ROWS = 6


def _words(leaf, shape, seed):
    """Raw words of a gradient-like (k, ...) leaf stack: spread exponents,
    each worker's non-finite words and range edges at its own positions, and
    a last 128 elements of only specials, edges and zeros."""
    rng = np.random.default_rng(seed)
    span = 4 if leaf == "fp16" else 12
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp2(rng.integers(-span, span, shape)).astype(np.float32)
    t = torch.from_numpy(x).to(TDT[leaf])
    words = t.view(INT[leaf][1]).numpy().view(np.uint32 if leaf == "fp32" else np.uint16)
    pool = np.concatenate([SPECIALS[leaf], EDGES[leaf]])
    flat = words.reshape(shape[0], -1)
    for w in range(shape[0]):
        pos = rng.choice(flat.shape[1] - 128, 12, replace=False)
        flat[w, pos] = rng.choice(pool, 12)
    flat[:, -128:] = 0
    flat[:, -128:-128 + len(pool)] = pool
    return words


def _torch(words, leaf):
    return torch.from_numpy(words.view(INT[leaf][0]).copy()).view(TDT[leaf])


def _jax(words, leaf):
    return jnp.asarray(words.view(INT[leaf][0])).view(JDT[leaf])


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()]).numpy()


def _jax_composition(words, leaf, fmt, offset, preshift, wire):
    """The reference's composition on a (k, R, B) stack: encode, the block
    max over k and B, arshift to that max plus ``offset`` (pre-shifted), the
    wire cast, the int32 sum over k, the wire again; then block_decode of
    the plane cast to the leaf's dtype."""
    f = jf.FORMATS[fmt]
    planes = jf.encode(_jax(words, leaf).astype(JDT[fmt]), f)
    local = planes.exp.max(axis=(0, 2))
    bmax = local + jnp.asarray(offset)
    man = jnx.arshift(planes.man, (bmax[None, :, None] - planes.exp) + preshift)
    wdt = WIRE_NP[wire]
    plane = man.astype(wdt).astype(jnp.int32).sum(axis=0, dtype=jnp.int32).astype(wdt)
    out = jf.block_decode(plane.astype(jnp.int32).reshape(-1), bmax, words.shape[2],
                          preshift, f).astype(JDT[leaf])
    return (np.array(local), np.array(bmax), np.array(plane),
            np.array(out).view(INT[leaf][0]).reshape(plane.shape))


CASES = [(fmt, leaf, wire, k, block) for fmt, leaf in PAIRS for wire in (32, 16, 8)
         for k in (1, 4) for block in (128, 256, 512)]


@pytest.mark.parametrize("fmt,leaf,wire,k,block", CASES,
                         ids=[f"{f}-{l}-w{w}-k{k}-B{b}" for f, l, w, k, b in CASES])
def test_plain_modes_equal_the_reference_composition(fmt, leaf, wire, k, block):
    seed = CASES.index((fmt, leaf, wire, k, block))
    words = _words(leaf, (k, ROWS, block), seed)
    rng = np.random.default_rng(seed + 1)
    offset = rng.integers(-5, 41, ROWS).astype(np.int32)  # shift distances -5..43
    preshift = int(rng.integers(0, 4))
    local, bmax, plane, out = _jax_composition(words, leaf, fmt, offset, preshift, wire)

    x = _torch(words, leaf)
    got_local = ops.block_max(x, fmt)
    assert got_local.dtype == torch.int32
    np.testing.assert_array_equal(got_local.numpy(), local)
    got_plane = ops.encode_wire(x, torch.from_numpy(bmax), preshift, wire, fmt)
    assert got_plane.dtype == fpisa_fused.wire_dtype(wire) and got_plane.shape == (ROWS, block)
    np.testing.assert_array_equal(got_plane.numpy(), plane.astype(got_plane.numpy().dtype))
    got = ops.decode_fused(got_plane, torch.from_numpy(bmax), preshift, fmt, TDT[leaf])
    assert got.dtype == TDT[leaf]
    np.testing.assert_array_equal(_bits(got), out)


DECODE_OUT = [(fmt, out, wire) for fmt in FMTS for out in FMTS for wire in (32, 16, 8)]


@pytest.mark.parametrize("fmt,out,wire", DECODE_OUT,
                         ids=[f"{f}-to-{o}-w{w}" for f, o, w in DECODE_OUT])
def test_decode_to_every_dtype_equals_the_reference_cast(fmt, out, wire):
    """K2's plain version into each output dtype: summed mantissas over the
    wire's whole range and block exponents past the format's, so the value
    hits zero, underflow, overflow to inf and the cast's rounding."""
    rng = np.random.default_rng(FMTS.index(fmt) * 9 + FMTS.index(out) * 3 + wire)
    info = np.iinfo(WIRE_NP[wire])
    block = {32: 128, 16: 256, 8: 512}[wire]
    m = rng.integers(info.min, info.max, (ROWS, block), endpoint=True).astype(WIRE_NP[wire])
    m.reshape(-1)[:4] = [info.min, -1, 0, info.max]
    bmax = rng.integers(0, jf.FORMATS[fmt].exp_mask + 2, ROWS).astype(np.int32)
    got = ops.decode_fused(torch.from_numpy(m), torch.from_numpy(bmax), 1, fmt, TDT[out])
    want = jf.block_decode(jnp.asarray(m).astype(jnp.int32).reshape(-1), jnp.asarray(bmax),
                           block, 1, jf.FORMATS[fmt]).astype(JDT[out])
    assert got.dtype == TDT[out]
    np.testing.assert_array_equal(_bits(got).reshape(-1), np.asarray(want).view(INT[out][0]))


def test_fp16_staged_to_fp32_keeps_each_nan_sign():
    """Every fp16 word through ``to_packed(.., "fp32")``: XLA's value for
    every non-NaN word, and for each NaN the quiet NaN of its own sign (the
    card's half -> float cast makes a NaN positive; encode clamps by the
    sign). K1's widening in registers gives the same encode planes."""
    words = np.arange(2**16, dtype=np.uint32).astype(np.uint16)
    got = tf.to_packed(torch.from_numpy(words.view(np.int16)).view(torch.float16), "fp32")
    got = got.view(torch.int32).numpy().view(np.uint32)
    want = np.asarray(jnp.asarray(words.view(np.float16)).astype(jnp.float32)).view(np.uint32)
    nan = ((words & 0x7C00) == 0x7C00) & ((words & 0x3FF) != 0)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    np.testing.assert_array_equal(got[nan], np.where(words[nan] >= 0x8000, 0xFFC00000,
                                                     0x7FC00000).astype(np.uint32))
    np.testing.assert_array_equal(want[nan] >> 31, words[nan] >> 15)  # XLA keeps it too


def test_new_modes_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="reads torch.bfloat16 leaves"):
        ops.block_max(torch.zeros((1, 2, 256)), "bf16")
    with pytest.raises(ValueError, match="reads torch.float16 leaves"):
        ops.encode_wire(torch.zeros((1, 2, 256), dtype=torch.bfloat16),
                        torch.zeros(2, dtype=torch.int32), 0, 32, "fp16")
    with pytest.raises(ValueError, match=r"\(k, R, B\) stack"):
        ops.block_max(torch.zeros((2, 256)), "fp32")
    assert fpisa_fused.widens(torch.bfloat16, "fp32")
    assert not fpisa_fused.widens(torch.float32, "bf16")
    assert not fpisa_fused.widens(torch.float16, "bf16")


def test_plain_versions_count_no_launch():
    before = (ops.block_max.launches, ops.encode_wire.launches, ops.decode_fused.launches,
              dict(ops.decode_fused.modes))
    x = torch.ones((2, 3, 256), dtype=torch.bfloat16)
    b = ops.block_max(x, "fp32")
    ops.decode_fused(ops.encode_wire(x, b, 1, 16, "fp32"), b, 1, "fp32", torch.bfloat16)
    assert (ops.block_max.launches, ops.encode_wire.launches, ops.decode_fused.launches,
            ops.decode_fused.modes) == before


# ---------------------------------------------------------------------------
# the header's arithmetic, compiled for the host
# ---------------------------------------------------------------------------

HARNESS = r"""
#include "fpisa_fused.cuh"
using namespace fpisa;

template <class F, int D, int WB>
static void passes(const void* xv, const int32_t* bmax, int32_t* local, int32_t* plane,
                   void* outv, int k, long rows, int block, int preshift) {
  using T = typename Bits<D>::T;
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  for (long r = 0; r < rows; ++r) {
    int32_t emax = 0;  // as the exponent mode takes it: max field, one clamp
    for (int w = 0; w < k; ++w)
      for (int i = 0; i < block; ++i) {
        const int32_t e = exp_field<F>(widen<F, D>(x[(w * rows + r) * block + i]));
        emax = emax > e ? emax : e;
      }
    local[r] = block_exp<F>(emax);
    for (int i = 0; i < block; ++i) {
      int32_t acc = 0;
      for (int w = 0; w < k; ++w) {
        const Plane p = encode<F>(widen<F, D>(x[(w * rows + r) * block + i]));
        acc = wrap_add(acc, to_wire<WB>(arshift(p.man, bmax[r] + preshift - p.exp)));
      }
      plane[r * block + i] = to_wire<WB>(acc);
      out[r * block + i] = (T)cast_to<F, D>(renormalize<F>(bmax[r] + preshift,
                                                            plane[r * block + i]));
    }
  }
}

template <class F, int D>
static int by_wire(int wire, const void* x, const int32_t* b, int32_t* l, int32_t* p,
                   void* o, int k, long rows, int block, int pre) {
  if (wire == 32) passes<F, D, 32>(x, b, l, p, o, k, rows, block, pre);
  else if (wire == 16) passes<F, D, 16>(x, b, l, p, o, k, rows, block, pre);
  else if (wire == 8) passes<F, D, 8>(x, b, l, p, o, k, rows, block, pre);
  else return 1;
  return 0;
}

extern "C" int host_passes(int fmt, int dtype, int wire, const void* x, const int32_t* b,
                           int32_t* l, int32_t* p, void* o, int k, long rows, int block,
                           int pre) {
  if (fmt == 0 && dtype == 0) return by_wire<Fp32, 0>(wire, x, b, l, p, o, k, rows, block, pre);
  if (fmt == 0 && dtype == 1) return by_wire<Fp32, 1>(wire, x, b, l, p, o, k, rows, block, pre);
  if (fmt == 0 && dtype == 2) return by_wire<Fp32, 2>(wire, x, b, l, p, o, k, rows, block, pre);
  if (fmt == 1 && dtype == 1) return by_wire<Fp16, 1>(wire, x, b, l, p, o, k, rows, block, pre);
  if (fmt == 2 && dtype == 2) return by_wire<Bf16, 2>(wire, x, b, l, p, o, k, rows, block, pre);
  return 1;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The header's arithmetic built with the host's C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler builds the header's arithmetic"
    d = tmp_path_factory.mktemp("header")
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(d / "harness.so"), str(d / "harness.cpp")], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(d / "harness.so"))
    lib.host_passes.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int]
    return lib


HOST_CASES = [(fmt, leaf, wire, k) for fmt, leaf in PAIRS for wire in (32, 16, 8) for k in (1, 4)]


@pytest.mark.parametrize("fmt,leaf,wire,k", HOST_CASES,
                         ids=[f"{f}-{l}-w{w}-k{k}" for f, l, w, k in HOST_CASES])
def test_header_arithmetic_equals_the_plain_versions(host_lib, fmt, leaf, wire, k):
    block = 256
    seed = 1000 + HOST_CASES.index((fmt, leaf, wire, k))
    words = _words(leaf, (k, ROWS, block), seed)
    x = _torch(words, leaf)
    f = tf.FORMATS[fmt]
    offset = torch.from_numpy(np.random.default_rng(seed).integers(-5, 41, ROWS)
                              .astype(np.int32))
    bmax = ref.block_max_ref(x, f) + offset
    local = torch.empty(ROWS, dtype=torch.int32)
    plane = torch.empty((ROWS, block), dtype=torch.int32)
    out = torch.empty((ROWS, block), dtype=TDT[leaf])
    codes = fpisa_fused.FMT_CODES
    assert host_lib.host_passes(codes[fmt], codes[leaf], wire, x.data_ptr(), bmax.data_ptr(),
                                local.data_ptr(), plane.data_ptr(), out.data_ptr(), k, ROWS,
                                block, 2) == 0
    assert torch.equal(local, ref.block_max_ref(x, f))
    want = ref.encode_wire_ref(x, bmax, 2, wire, f)
    assert torch.equal(plane, want.to(torch.int32))
    assert np.array_equal(_bits(out), _bits(ref.fused_decode_ref(want, bmax, 2, f, TDT[leaf])))


# ---------------------------------------------------------------------------
# core/allreduce.py: the cuda branch's composition against the torch branch
# ---------------------------------------------------------------------------

BRANCH_CASES = [(fmt, leaf, wire) for fmt, leaf in PAIRS + [("bf16", "fp32"), ("fp16", "fp32"),
                                                           ("fp16", "bf16")]
                for wire in (32, 16, 8)]


@pytest.fixture
def cuda_branch(monkeypatch):
    """``resolve_backend`` answering "cuda" for CPU tensors: the cuda
    branch runs, and ``ops`` takes the plain versions."""
    monkeypatch.setattr(tar, "resolve_backend",
                        lambda backend, device=None: backend if backend == "torch" else "cuda")


def _leaf(leaf, shape, seed):
    return _torch(_words(leaf, (1, int(np.prod(shape))), seed)[0], leaf).reshape(shape)


@pytest.mark.parametrize("fmt,leaf,wire", BRANCH_CASES,
                         ids=[f"{f}-{l}-w{w}" for f, l, w in BRANCH_CASES])
def test_cuda_branch_helpers_equal_the_torch_branch(fmt, leaf, wire):
    cfg = AggConfig(fmt_name=fmt, wire_bits=wire)
    shift = tar._wire_shift(cfg.fmt, 4, wire)
    flat = _leaf(leaf, (4 * cfg.block,), FMTS.index(fmt) * 7 + wire).reshape(-1)
    per_leaf = {b: tar._encode_align(flat, None, shift, wire, cfg, b) for b in ("cuda", "torch")}
    rows = _torch(_words(leaf, (4, 3, cfg.block), wire + 3), leaf).reshape(4, -1)
    stacked = {b: tar._encode_align_stacked(rows, None, shift, wire, cfg, b)
               for b in ("cuda", "torch")}
    for planes in (per_leaf, stacked):
        (man_c, bmax_c), (man_t, bmax_t) = planes["cuda"], planes["torch"]
        assert man_c.dtype == fpisa_fused.wire_dtype(wire)  # int16 travels as int32
        assert torch.equal(bmax_c, bmax_t)
        assert torch.equal(man_c.to(torch.int32), man_t.to(torch.int32))
        sums = {b: tar._psum_wire(planes[b][0], None) for b in planes}
        outs = [tar._decode(sums[b], bmax_t, shift, cfg, b, TDT[leaf]) for b in planes]
        assert outs[0].dtype == outs[1].dtype == TDT[leaf]
        assert np.array_equal(_bits(outs[0]), _bits(outs[1]))


@pytest.mark.parametrize("fmt,leaf,wire", BRANCH_CASES,
                         ids=[f"{f}-{l}-w{w}" for f, l, w in BRANCH_CASES])
def test_cuda_branch_paths_equal_the_torch_branch(cuda_branch, fmt, leaf, wire):
    """The flat (padded), stacked (k = 4) and hierarchical paths at W = 1,
    and the flat path's split phases."""
    cfgs = {b: AggConfig(fmt_name=fmt, wire_bits=wire, backend=b) for b in ("cuda", "torch")}
    x = _leaf(leaf, (3, 300), wire)  # 900 elements: the last block padded
    xs = _torch(_words(leaf, (4, 3, 300), wire + 1), leaf)
    runs = {b: [tar.fpisa_allreduce(x, None, c), tar.stacked_fpisa_allreduce(xs, None, c),
                tar.fpisa_allreduce_hierarchical(x, None, None, c)]
            for b, c in cfgs.items()}
    for got, want in zip(runs["cuda"], runs["torch"]):
        assert got.dtype == want.dtype == TDT[leaf] and got.shape == want.shape
        assert np.array_equal(_bits(got), _bits(want))
    flat = tf.to_packed(x.reshape(-1)[:768], fmt)  # a bucket buffer: packed, block multiple
    outs = []
    for b in ("cuda", "torch"):
        encode, collect, finish = tar._fpisa_flat_phases(None, cfgs[b], b)
        outs.append(finish(collect(encode(flat))))
    assert np.array_equal(_bits(outs[0]), _bits(outs[1]))


def test_cuda_branch_takes_a_leaf_dtype_k2_does_not_write(cuda_branch):
    """A float64 leaf: cast to the format before the kernels, decoded in the
    format's dtype and cast after, as on the torch branch."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(700))
    for fmt in FMTS:
        got, want = (tar.fpisa_allreduce(x, None, AggConfig(fmt_name=fmt, backend=b))
                     for b in ("cuda", "torch"))
        assert got.dtype == torch.float64 and torch.equal(got, want)


def test_cuda_branch_copies_a_misaligned_view(cuda_branch):
    """A chunk cut at an odd offset starts off a 16-byte boundary: the
    kernels' input is copied to an aligned tensor first, same bits."""
    cfg = AggConfig(fmt_name="fp32")
    base = _leaf("bf16", (2 * cfg.block + 3,), 5)
    view = base[3:]
    assert view.data_ptr() % 16
    staged = tar._kernel_input(view, cfg)
    assert staged.data_ptr() % 16 == 0 and np.array_equal(_bits(staged), _bits(view))
    got = tar.fpisa_allreduce(view, None, AggConfig(fmt_name="fp32", backend="cuda"))
    want = tar.fpisa_allreduce(view, None, AggConfig(fmt_name="fp32", backend="torch"))
    assert np.array_equal(_bits(got), _bits(want))
