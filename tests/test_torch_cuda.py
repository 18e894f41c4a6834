"""The port's CUDA kernels on the card: K1 (fpisa_encode_align; its exponent
and wire modes fpisa_block_max and fpisa_encode_wire), K2
(fpisa_decode_fused, into every dtype), K3 (fpisa_extract), K4 (fpisa_align), K5
(fpisa_decode) and K6 (fpisa_accum; its leaf mode fpisa_accum_leaf, with a
ragged row and an unaligned base) against their plain PyTorch versions on
the same CUDA tensors, bit for bit (integer views), over the CPU suite's
sweep plus the special values; their launch counters; the wrappers'
refusals; and bucketed (K1/K2 once per bucket), chunked, hierarchical (a
pair of one-rank NCCL groups) and bucketed ``fpisa_seq`` aggregation on the
cuda backend against the plain per-leaf aggregation; stacked (logical-worker)
``fpisa`` (K1/K2 once per leaf over k = 2, 4, 8 workers) and ``fpisa_seq``
(K6 at W = 2, 4, 8) against the plain stacked aggregation; checkpoint round
trips of CUDA bf16 and fp32 tensors; and the backward's bits repeated under
``runtime.elastic.reproducible``; serving on the card (prefill, dense and
paged decode against the CPU plain path, paged == dense and batch-invariant
rows bit for bit) and serving telemetry through K1/K2 and K6; the
XLA-style non-finite casts (F8, F9) and non-finite aggregation against the
CPU; the switch dataplane (``BatchedDataplane`` single- and multi-tenant)
and the query operators on the card against the CPU and the numpy
dataplane, also under deterministic algorithms; the model families on the
card: GQA at g = 7, the MoE overflow (F10) and the SSD recurrence against
the chunked scan; ``remat="dots"`` against ``"full"`` bit for bit on every
decoder-only family, A1 launched as under ``"full"``; the encoder-decoder's
training and serving against the CPU; the train step's phase spans on the
card (device intervals that tile the step, the profiler's GPU user
annotations). These tests
need an NVIDIA GPU and nvcc;
elsewhere they skip. They import nothing of JAX, so the GPU machine runs them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fpisa  # noqa: E402
from repro_torch.core import numerics as nx  # noqa: E402
from repro_torch.core.allreduce import _wire_shift  # noqa: E402
from repro_torch.core.agg import AggConfig, Aggregator  # noqa: E402
from repro_torch.kernels import fpisa_accum, fpisa_decode, fpisa_encode  # noqa: E402
from repro_torch.kernels import fpisa_fused, ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPES = [(1, 256), (8, 128), (256, 256), (300, 512), (513, 128), (64, 512)]
FMTS = ["fp32", "fp16", "bf16"]
INT_VIEW = {"fp32": torch.int32, "fp16": torch.int16, "bf16": torch.int16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _x(shape, fmt, seed, dev):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp2(rng.integers(-12, 12, shape)).astype(np.float32)
    specials = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-39, -1e-39, 3e-8]
    x.reshape(-1)[: min(8, x.size)] = specials[: x.size]
    return torch.from_numpy(x).to(dev).to(fpisa.PACKED_DTYPE[fmt])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fmt", FMTS)
def test_encode_align_kernel_equals_plain(dev, shape, fmt):
    x = _x(shape, fmt, shape[0], dev)
    man, bmax = ops.encode_align(x, fmt)
    man_r, bmax_r = ref.fused_encode_align_ref(x, fpisa.FORMATS[fmt])
    torch.cuda.synchronize()
    assert torch.equal(man, man_r) and torch.equal(bmax, bmax_r)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("wire", [torch.int8, torch.int16, torch.int32], ids=str)
@pytest.mark.parametrize("preshift", [0, 2])
def test_decode_kernel_equals_plain(dev, shape, fmt, wire, preshift):
    gen = torch.Generator(device=dev).manual_seed(shape[0] * 3 + preshift)
    info = torch.iinfo(wire)
    m = torch.randint(info.min, info.max, shape, generator=gen, device=dev,
                      dtype=torch.int64).to(wire)
    m.view(-1)[:4] = torch.tensor([info.min, -1, 0, info.max], dtype=wire)[: m.numel()]
    bmax = torch.randint(0, fpisa.FORMATS[fmt].exp_mask + 2, (shape[0],), generator=gen,
                         device=dev, dtype=torch.int32)
    out = ops.decode_fused(m, bmax, preshift, fmt)
    want = ref.fused_decode_ref(m, bmax, preshift, fpisa.FORMATS[fmt])
    torch.cuda.synchronize()
    assert torch.equal(out.view(INT_VIEW[fmt]), want.view(INT_VIEW[fmt]))


def test_launch_counters_count_kernel_launches(dev):
    before = (ops.encode_align.launches, ops.decode_fused.launches)
    m, b = ops.encode_align(torch.ones((4, 256), device=dev), "fp32")
    ops.decode_fused(m, b, 0, "fp32")
    assert (ops.encode_align.launches, ops.decode_fused.launches) == \
        (before[0] + 1, before[1] + 1)


def test_kernels_refuse_what_they_do_not_take(dev):
    with pytest.raises(ValueError, match="B in"):
        fpisa_fused.fused_encode_align(torch.ones((4, 64), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        fpisa_fused.fused_encode_align(torch.ones((256, 4), device=dev).T)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fpisa_fused.fused_decode(torch.ones((4, 256), dtype=torch.int32),
                                 torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("wire", [32, 16, 8])
def test_four_worker_composition_equals_plain(dev, wire):
    """K1 on each of 4 workers' gradients, MAX of the block exponents,
    residual shift and wire cast, integer sum, K2 — bit-equal to the same
    composition through the plain versions."""
    fmt = fpisa.FP32
    shift = _wire_shift(fmt, 4, wire)
    xs = [_x((300, 256), "fp32", 40 + i, dev) for i in range(4)]

    def compose(encode, decode):
        planes = [encode(x) for x in xs]
        bmax = torch.stack([b for _, b in planes]).amax(0)
        wdt = {32: torch.int32, 16: torch.int16, 8: torch.int8}[wire]
        total = sum(nx.arshift(m, (bmax - b)[:, None] + shift).to(wdt).to(torch.int32)
                    for m, b in planes)
        return decode(total.to(wdt), bmax)

    got = compose(lambda x: ops.encode_align(x, "fp32"),
                  lambda m, b: ops.decode_fused(m, b, shift, "fp32"))
    want = compose(lambda x: ref.fused_encode_align_ref(x, fmt),
                   lambda m, b: ref.fused_decode_ref(m, b, shift, fmt))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("fmt", FMTS)
def test_cuda_backend_aggregator_equals_torch_backend(dev, fmt):
    x = _x((5, 1000), "fp32", 7, dev)
    x = torch.nan_to_num(x, posinf=1.0, neginf=-1.0)
    got = Aggregator(AggConfig(backend="cuda", fmt_name=fmt)).allreduce(x)
    want = Aggregator(AggConfig(backend="torch", fmt_name=fmt)).allreduce(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# K1's exponent and wire modes, K2 into the leaf's dtype
# ---------------------------------------------------------------------------

LEAF_PAIRS = [("fp32", "fp32"), ("fp32", "bf16"), ("fp32", "fp16"), ("fp16", "fp16"),
              ("bf16", "bf16")]
MODE_WORDS = {"fp32": (0x7FC00000, -0x400000, 0x7F800001, -0x7FFFFF, 0x7F7FFFFF, 0x800000, 1),
              "bf16": (0x7FC0, -0x40, 0x7F81, -0x7F, 0x7F7F, 0x0080, 1),
              "fp16": (0x7E00, -0x200, 0x7C01, -0x3FF, 0x7BFF, 0x0400, 1)}


def _leaf_stack(k, shape, leaf, seed, dev):
    """(k, R, B) leaves with _x's specials and each dtype's NaN words (both
    signs, quiet and signalling), largest finite, smallest normal, a denormal."""
    xs = []
    for j in range(k):
        x = _x(shape, leaf, seed + j, dev)
        words = torch.tensor(MODE_WORDS[leaf], device=dev,
                             dtype=INT_VIEW[leaf]).view(fpisa.PACKED_DTYPE[leaf])
        n = max(0, min(len(words), x.numel() - 8))
        x.view(-1)[8:8 + n] = words[:n]
        xs.append(x)
    return torch.stack(xs)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fmt,leaf", LEAF_PAIRS, ids=[f"{f}-{l}" for f, l in LEAF_PAIRS])
@pytest.mark.parametrize("k", [1, 4])
def test_exponent_and_wire_modes_equal_plain(dev, shape, fmt, leaf, k):
    """Exponent mode, wire mode (wires 32/16/8, block exponents -5..40 off
    the block max) and K2 into the leaf's dtype: the kernels' bits are the
    plain versions'."""
    f = fpisa.FORMATS[fmt]
    x = _leaf_stack(k, shape, leaf, shape[0] + k, dev)
    b_r = ref.block_max_ref(x, f)
    b = ops.block_max(x, fmt)
    gen = torch.Generator(device=dev).manual_seed(shape[1] + k)
    be = b_r + torch.randint(-5, 41, b_r.shape, generator=gen, device=dev, dtype=torch.int32)
    assert torch.equal(b, b_r)
    for wire in (32, 16, 8):
        plane = ops.encode_wire(x, be, wire % 3, wire, fmt)
        plane_r = ref.encode_wire_ref(x, be, wire % 3, wire, f)
        assert plane.dtype == plane_r.dtype and torch.equal(plane, plane_r)
        out = ops.decode_fused(plane, be, wire % 3, fmt, x.dtype)
        want = ref.fused_decode_ref(plane_r, be, wire % 3, f, x.dtype)
        torch.cuda.synchronize()
        assert out.dtype == x.dtype
        assert torch.equal(out.view(INT_VIEW[leaf]), want.view(INT_VIEW[leaf]))


def test_fp16_staged_to_fp32_on_the_card_equals_the_cpu(dev):
    """``to_packed`` of every fp16 word to fp32 gives the CPU's bits on the
    card: each NaN keeps its sign (the card's own cast makes it positive)."""
    x = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(torch.float16)
    assert torch.equal(fpisa.to_packed(x.to(dev), "fp32").cpu().view(torch.int32),
                       fpisa.to_packed(x, "fp32").view(torch.int32))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("out", FMTS)
def test_decode_into_every_dtype_equals_plain(dev, fmt, out):
    gen = torch.Generator(device=dev).manual_seed(FMTS.index(fmt) * 3 + FMTS.index(out))
    m = torch.randint(-2**31, 2**31 - 1, (300, 256), generator=gen, device=dev,
                      dtype=torch.int64).to(torch.int32)
    bmax = torch.randint(0, fpisa.FORMATS[fmt].exp_mask + 2, (300,), generator=gen,
                         device=dev, dtype=torch.int32)
    dt = fpisa.PACKED_DTYPE[out]
    got = ops.decode_fused(m, bmax, 1, fmt, dt)
    want = ref.fused_decode_ref(m, bmax, 1, fpisa.FORMATS[fmt], dt)
    torch.cuda.synchronize()
    assert got.dtype == dt and torch.equal(got.view(INT_VIEW[out]), want.view(INT_VIEW[out]))


@pytest.mark.parametrize("wire", [32, 16, 8])
@pytest.mark.parametrize("leaf", [torch.float32, torch.bfloat16])
def test_four_worker_modes_equal_the_local_mode_composition(dev, wire, leaf):
    """The 4 workers' aggregation through the exponent mode, the wire mode
    (the fold inside) and K2 in the leaf's dtype gives the local mode's
    composition's bits (the residual shift, wire cast and int sum in torch,
    K2 in fp32, the cast back)."""
    shift = _wire_shift(fpisa.FP32, 4, wire)
    x4 = torch.stack([torch.nan_to_num(_x((300, 256), "fp32", 40 + i, dev), posinf=3.0,
                                       neginf=-3.0) for i in range(4)]).to(leaf)
    b = ops.block_max(x4, "fp32")
    got = ops.decode_fused(ops.encode_wire(x4, b, shift, wire, "fp32"), b, shift, "fp32", leaf)
    planes = [ops.encode_align(x.float(), "fp32") for x in x4]
    wdt = {32: torch.int32, 16: torch.int16, 8: torch.int8}[wire]
    total = sum(nx.arshift(m, (b - lb)[:, None] + shift).to(wdt).to(torch.int32)
                for m, lb in planes)
    want = ops.decode_fused(total.to(wdt), b, shift, "fp32").to(leaf)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_mode_launch_counters_count_kernel_launches(dev):
    before = _k1k2_launches() + (dict(ops.decode_fused.modes),)
    x = torch.ones((2, 4, 256), dtype=torch.bfloat16, device=dev)
    b = ops.block_max(x, "fp32")
    m = ops.encode_wire(x, b, 1, 16, "fp32")
    ops.decode_fused(m, b, 1, "fp32", torch.bfloat16)
    ops.decode_fused(m, b, 1, "fp32")
    assert _k1k2_launches(before[:4]) == (0, 1, 1, 2)
    assert ops.decode_fused.modes == {"format": before[4]["format"] + 1,
                                      "leaf": before[4]["leaf"] + 1}


def test_modes_refuse_what_they_do_not_take(dev):
    i32 = dict(dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fpisa_fused.block_max(torch.ones((1, 4, 256)))
    with pytest.raises(ValueError, match=r"\(k, R, B\)"):
        fpisa_fused.block_max(torch.ones((4, 256), device=dev))
    with pytest.raises(ValueError, match="reads"):
        fpisa_fused.block_max(torch.ones((1, 4, 256), device=dev), "bf16")
    with pytest.raises(ValueError, match="16-byte boundary"):
        fpisa_fused.block_max(torch.ones(1 * 4 * 256 + 1, device=dev)[1:].view(1, 4, 256))
    with pytest.raises(ValueError, match="bmax must be"):
        fpisa_fused.encode_wire(torch.ones((1, 4, 256), device=dev), torch.zeros(5, **i32),
                                0, 32)
    with pytest.raises(ValueError, match="wire_bits"):
        fpisa_fused.encode_wire(torch.ones((1, 4, 256), device=dev), torch.zeros(4, **i32),
                                0, 12)
    with pytest.raises(ValueError, match="out_dtype"):
        fpisa_fused.fused_decode(torch.zeros((4, 256), **i32), torch.zeros(4, **i32), 0,
                                 "fp32", torch.float64)


@pytest.mark.parametrize("leaf", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("fmt", FMTS)
def test_cuda_backend_equals_torch_backend_for_each_leaf_dtype(dev, leaf, fmt):
    """bf16 and fp16 leaves: read as they are where the format holds them,
    cast first elsewhere; K2 writes the leaf's dtype. Per leaf (ragged) and
    stacked, same bits as the torch backend."""
    x = torch.nan_to_num(_x((5, 1000), "fp32", 9, dev), posinf=1.0, neginf=-1.0).to(leaf)
    xs = torch.stack([x, x * 0.5, -x, x * 3])
    view = INT_VIEW["fp16"]
    for stacked, t in ((False, x), (True, xs)):
        got = Aggregator(AggConfig(backend="cuda", fmt_name=fmt), stacked=stacked).allreduce(t)
        want = Aggregator(AggConfig(backend="torch", fmt_name=fmt), stacked=stacked).allreduce(t)
        assert got.dtype == want.dtype == leaf
        assert torch.equal(got.view(view), want.view(view))


def test_k1k2_on_a_leaf_whose_wire_plane_passes_2_31_bytes(dev):
    """A bf16 leaf of 560,000,000 elements (2,187,500 rows of 256): its int32
    wire plane holds 2.24 GB, past 2^31 bytes, as the stacked ``in_proj`` of
    the zamba2 cell's 24 layers does (1,264.8 M elements). K1's exponent and
    wire modes and K2 on the cuda backend equal the torch backend bit for
    bit, the elements past the 2^31-byte mark among them."""
    n = 560_000_000
    assert 4 * n > 2**31
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.empty(n, dtype=torch.bfloat16, device=dev).normal_(0.0, 0.02, generator=gen)
    x[-257:] = torch.linspace(-3.0, 3.0, 257, device=dev).to(torch.bfloat16)
    before = _k1k2_launches()
    got = Aggregator(AggConfig(backend="cuda")).allreduce(x)
    assert _k1k2_launches(before) == (0, 1, 1, 1)
    want = Aggregator(AggConfig(backend="torch")).allreduce(x)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(got[-257:].view(torch.int16), want[-257:].view(torch.int16))


# ---------------------------------------------------------------------------
# K3-K6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fmt", FMTS)
def test_extract_kernel_equals_plain(dev, shape, fmt):
    x = _x(shape, fmt, shape[1], dev)
    got = ops.extract(x, fmt)
    want = ref.extract_ref(x, fpisa.FORMATS[fmt])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("preshift", [0, 2])
def test_align_kernel_equals_plain(dev, shape, preshift):
    exp, man, bmax = ref.extract_ref(_x(shape, "fp32", shape[0] + 5, dev), fpisa.FP32)
    gen = torch.Generator(device=dev).manual_seed(shape[0])
    bmax = bmax + torch.randint(0, 40, bmax.shape, generator=gen, device=dev,
                                dtype=torch.int32)
    got = ops.align(exp, man, bmax, preshift)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.align_ref(exp, man, bmax, preshift))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("preshift", [0, 2])
def test_two_pass_decode_kernel_equals_plain(dev, shape, fmt, preshift):
    gen = torch.Generator(device=dev).manual_seed(shape[0] * 5 + preshift)
    m = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=dev, dtype=torch.int64)
    m = m.to(torch.int32)
    m.view(-1)[:4] = torch.tensor([-2**31, -1, 0, 2**31 - 1], dtype=torch.int32)[: m.numel()]
    bmax = torch.randint(0, fpisa.FORMATS[fmt].exp_mask + 2, (shape[0],), generator=gen,
                         device=dev, dtype=torch.int32)
    out = ops.decode(m, bmax, preshift, fmt)
    want = ref.decode_ref(m, bmax, preshift, fpisa.FORMATS[fmt])
    torch.cuda.synchronize()
    assert out.dtype == want.dtype == fpisa.PACKED_DTYPE[fmt]
    assert torch.equal(out.view(INT_VIEW[fmt]), want.view(INT_VIEW[fmt]))


def _stack(workers, fmt, dev, seed):
    """(W, 64, 256) gradient-like values; row 0 forces the FPISA-A edges:
    columns 0..4 the largest mantissa at exponent = headroom from every
    worker (left shift by the full headroom; the register wraps), column 4
    from worker 1 at headroom + 1 (overwrite)."""
    f = fpisa.FORMATS[fmt]
    x = torch.stack([_x((64, 256), fmt, seed + i, dev) for i in range(workers)])
    bits = x.view(INT_VIEW[fmt])
    bits[:, 0, :5] = (f.headroom << f.man_bits) | f.man_mask
    bits[1:2, 0, 4] = ((f.headroom + 1) << f.man_bits) | f.man_mask
    return x


@pytest.mark.parametrize("workers", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("variant", ["fpisa_a", "full"])
@pytest.mark.parametrize("fmt", FMTS)
def test_accum_kernel_equals_plain(dev, workers, variant, fmt):
    x = _stack(workers, fmt, dev, seed=workers)
    out = ops.accum(x, variant, fmt)
    want = ref.accum_ref(x, variant, fpisa.FORMATS[fmt])
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (64, 256)
    assert torch.equal(out.view(torch.int32), want.to(torch.float32).view(torch.int32))


def _accum_leaf_stack(workers, fmt, leaf, shape, seed, dev):
    """(W, *shape) leaf stack in dtype ``leaf``: ``_leaf_stack``'s values,
    specials and non-finite words; where the leaf has the format's exponent
    range, ``_stack``'s FPISA-A edges in its first 5 elements (the headroom
    shift, the wrap, the overwrite). K6's leaf mode reads ``LEAF_PAIRS``."""
    x = _leaf_stack(workers, shape, leaf, seed, dev)
    if leaf == fmt or (leaf, fmt) == ("bf16", "fp32"):
        h, lf = fpisa.FORMATS[fmt].headroom, fpisa.FORMATS[leaf]
        bits = x.view(INT_VIEW[leaf]).reshape(workers, -1)
        bits[:, :5] = (h << lf.man_bits) | lf.man_mask
        bits[1:2, 4] = ((h + 1) << lf.man_bits) | lf.man_mask
    return x


@pytest.mark.parametrize("workers", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("variant", ["fpisa_a", "full"])
@pytest.mark.parametrize("fmt,leaf", LEAF_PAIRS)
def test_accum_leaf_kernel_equals_plain(dev, workers, variant, fmt, leaf):
    """K6's leaf mode: the leaf's dtype in and out, bit for bit the plain
    version's (the reference's sum, cast to the leaf's dtype)."""
    x = _accum_leaf_stack(workers, fmt, leaf, (64, 256), 10 + workers, dev)
    out = ops.accum_leaf(x, variant, fmt)
    want = ref.accum_leaf_ref(x, variant, fpisa.FORMATS[fmt])
    torch.cuda.synchronize()
    assert out.dtype == x.dtype and out.shape == (64, 256)
    assert torch.equal(out.view(INT_VIEW[leaf]), want.view(INT_VIEW[leaf]))


@pytest.mark.parametrize("workers", [1, 3, 4])
@pytest.mark.parametrize("fmt,leaf", LEAF_PAIRS)
def test_accum_modes_take_a_ragged_row_and_an_unaligned_base(dev, workers, fmt, leaf):
    """A row of 100,003 elements (the tail after the last 16-byte word) and
    the same stack one element off a 16-byte boundary (the whole of it in
    the one-element-a-thread kernel): both modes, both variants, equal to
    their plain versions."""
    x = _accum_leaf_stack(workers, fmt, leaf, (100_003,), 30 + workers, dev)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    buf[1:].copy_(x.reshape(-1))
    f = fpisa.FORMATS[fmt]
    for xs in (x, buf[1:].view(x.shape)):
        for variant in ("fpisa_a", "full"):
            got = ops.accum_leaf(xs, variant, fmt)
            want = ref.accum_leaf_ref(xs, variant, f)
            assert torch.equal(got.view(INT_VIEW[leaf]), want.view(INT_VIEW[leaf]))
            if leaf == fmt:
                x3 = xs.reshape(workers, 1, -1)
                assert torch.equal(ops.accum(x3, variant, fmt).view(torch.int32),
                                   ref.accum_ref(x3, variant, f).float().view(torch.int32))


def test_accum_counts_its_launches_by_mode(dev):
    before = (ops.accum.launches, dict(ops.accum.launches_by_mode))
    ops.accum(torch.ones((2, 4, 256), device=dev), "full", "fp32")
    ops.accum_leaf(torch.ones((2, 1000), dtype=torch.bfloat16, device=dev), "fpisa_a", "fp32")
    ops.accum_leaf(torch.ones((3, 7), device=dev), "full", "fp32")
    assert ops.accum.launches == before[0] + 3
    assert ops.accum.launches_by_mode == {"local": before[1]["local"] + 1,
                                          "leaf": before[1]["leaf"] + 2}


def test_new_launch_counters_count_kernel_launches(dev):
    before = [f.launches for f in (ops.extract, ops.align, ops.decode, ops.accum)]
    exp, man, bmax = ops.extract(torch.ones((4, 256), device=dev), "fp32")
    ops.decode(ops.align(exp, man, bmax, 0), bmax, 0, "fp32")
    ops.accum(torch.ones((2, 4, 256), device=dev), "full", "fp32")
    assert [f.launches for f in (ops.extract, ops.align, ops.decode, ops.accum)] == \
        [b + 1 for b in before]


def test_new_kernels_refuse_what_they_do_not_take(dev):
    i32 = dict(dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="B in"):
        fpisa_encode.fpisa_extract(torch.ones((4, 64), device=dev))
    with pytest.raises(ValueError, match="must be torch.float16"):
        fpisa_encode.fpisa_extract(torch.ones((4, 256), device=dev), "fp16")
    with pytest.raises(ValueError, match="exp must be"):
        fpisa_encode.fpisa_align(torch.zeros((4, 128), **i32), torch.zeros((4, 256), **i32),
                                 torch.zeros(4, **i32))
    with pytest.raises(ValueError, match="bmax must be"):
        fpisa_encode.fpisa_align(torch.zeros((4, 256), **i32), torch.zeros((4, 256), **i32),
                                 torch.zeros(5, **i32))
    with pytest.raises(ValueError, match="man_sum must be int32"):
        fpisa_decode.fpisa_decode(torch.zeros((4, 256), dtype=torch.int16, device=dev),
                                  torch.zeros(4, **i32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fpisa_decode.fpisa_decode(torch.zeros((4, 256), dtype=torch.int32),
                                  torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(W, R, B\)"):
        fpisa_accum.fpisa_accum(torch.ones((4, 256), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        fpisa_accum.fpisa_accum(torch.ones((256, 4, 2), device=dev).transpose(0, 2))
    with pytest.raises(ValueError, match="variant"):
        fpisa_accum.fpisa_accum(torch.ones((2, 4, 256), device=dev), "fpisa_b")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fpisa_accum.fpisa_accum(torch.ones((2, 4, 256)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fpisa_accum.fpisa_accum_leaf(torch.ones((2, 256), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="reads torch.bfloat16"):
        fpisa_accum.fpisa_accum_leaf(torch.ones((2, 256), device=dev), fmt_name="bf16")
    with pytest.raises(ValueError, match="reads torch.float16"):
        fpisa_accum.fpisa_accum_leaf(torch.ones((2, 256), dtype=torch.bfloat16, device=dev),
                                     fmt_name="fp16")
    with pytest.raises(ValueError, match="contiguous"):
        fpisa_accum.fpisa_accum_leaf(torch.ones((256, 2), device=dev).t())
    with pytest.raises(ValueError, match="variant"):
        fpisa_accum.fpisa_accum_leaf(torch.ones((2, 256), device=dev), "fpisa_b")
    with pytest.raises(ValueError, match="W >= 1"):
        fpisa_accum.fpisa_accum_leaf(torch.ones((0, 256), device=dev))


@pytest.mark.parametrize("leaf", FMTS)
@pytest.mark.parametrize("fmt", FMTS)
def test_cuda_fpisa_seq_of_each_leaf_dtype_equals_torch_backend(dev, leaf, fmt):
    """fpisa_seq per leaf and stacked (k = 4) on a ragged leaf of each dtype
    under each format: one leaf-mode launch each (the leaf gathered as it
    is, or staged to the format's dtype first), no local-mode launch, the
    torch backend's bits."""
    x = torch.nan_to_num(_x((4, 5, 1000), "fp32", 9, dev), posinf=1.0, neginf=-1.0)
    x = x.to(fpisa.PACKED_DTYPE[leaf])
    for stacked, t in ((False, x[0]), (True, x)):
        want = Aggregator(AggConfig(strategy="fpisa_seq", backend="torch", fmt_name=fmt),
                          stacked=stacked).allreduce(t)
        before = dict(ops.accum.launches_by_mode)
        got = Aggregator(AggConfig(strategy="fpisa_seq", backend="cuda", fmt_name=fmt),
                         stacked=stacked).allreduce(t)
        assert ops.accum.launches_by_mode == {"local": before["local"],
                                              "leaf": before["leaf"] + 1}
        assert got.dtype == t.dtype and torch.equal(got.view(INT_VIEW[leaf]),
                                                    want.view(INT_VIEW[leaf]))


@pytest.mark.parametrize("fmt", FMTS)
def test_cuda_fpisa_seq_equals_torch_backend(dev, fmt):
    """The fpisa_seq strategy on a ragged leaf: K6's leaf mode over the (W,
    N) stack on the cuda backend, fpisa_sum_sequential on torch; same bits."""
    x = torch.nan_to_num(_x((5, 1000), "fp32", 8, dev), posinf=1.0, neginf=-1.0)
    got = Aggregator(AggConfig(strategy="fpisa_seq", backend="cuda", fmt_name=fmt)).allreduce(x)
    want = Aggregator(AggConfig(strategy="fpisa_seq", backend="torch",
                                fmt_name=fmt)).allreduce(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# bucketed, chunked and hierarchical aggregation on the card
# ---------------------------------------------------------------------------


def _tree(dev):
    """A ragged gradient tree on the card: fp32 and bf16 leaves, a scalar,
    leaves that span buckets and leaves that are not block multiples."""
    shapes = {"a": (37, 13), "b": (5000,), "c": (), "d": (700,), "e": (3, 1300)}
    tree = {k: torch.nan_to_num(_x(s, "fp32", i, dev), posinf=1.0, neginf=-1.0)
            for i, (k, s) in enumerate(shapes.items())}
    tree["f"] = torch.nan_to_num(_x((400,), "fp32", 9, dev), posinf=1.0,
                                 neginf=-1.0).to(torch.bfloat16)
    return tree


def _same_bits(got, want):
    for k in want:
        view = torch.int32 if want[k].element_size() == 4 else torch.int16
        assert got[k].is_cuda and got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].reshape(-1).view(view), want[k].reshape(-1).view(view)), k


def _k1k2_launches(before=(0, 0, 0, 0)):
    """K1's local, exponent and wire mode launches and K2's, less ``before``."""
    now = (ops.encode_align.launches, ops.block_max.launches, ops.encode_wire.launches,
           ops.decode_fused.launches)
    return tuple(a - b for a, b in zip(now, before))


@pytest.mark.parametrize("wire", [32, 16, 8])
@pytest.mark.parametrize("fmt", FMTS)
def test_bucketed_cuda_equals_per_leaf_plain(dev, wire, fmt):
    """Bucketed on the cuda backend (K1's exponent and wire modes and K2
    once per bucket, K1's local mode never) equals the
    per-leaf plain torch aggregation, bit for bit."""
    from repro_torch.core.bucketer import make_plan

    tree = _tree(dev)
    base = dict(wire_bits=wire, fmt_name=fmt)
    want = Aggregator(AggConfig(backend="torch", **base)).allreduce_tree(tree)
    cfg = AggConfig(backend="cuda", bucket_bytes=8192, **base)
    buckets = len(make_plan(list(tree.values()), block=256, bucket_bytes=8192).buckets)
    before = _k1k2_launches()
    got = Aggregator(cfg).allreduce_tree(tree)
    assert _k1k2_launches(before) == (0, buckets, buckets, buckets)
    _same_bits(got, want)


def test_chunked_and_bucketed_fpisa_seq_on_the_card(dev):
    tree = _tree(dev)
    want = Aggregator(AggConfig(backend="torch")).allreduce_tree(tree)
    _same_bits(Aggregator(AggConfig(backend="cuda", chunk_elems=1024)).allreduce_tree(tree), want)
    _same_bits(Aggregator(AggConfig(backend="cuda", chunk_elems=1024,
                                    bucket_bytes=8192)).allreduce_tree(tree), want)
    seq = Aggregator(AggConfig(strategy="fpisa_seq", backend="torch")).allreduce_tree(tree)
    before = ops.accum.launches
    got = Aggregator(AggConfig(strategy="fpisa_seq", backend="cuda",
                               bucket_bytes=8192)).allreduce_tree(tree)
    assert ops.accum.launches > before
    _same_bits(got, seq)


@pytest.mark.parametrize("pod_wire", [32, 16, 8])
def test_hierarchical_cuda_equals_per_leaf_plain(dev, pod_wire, tmp_path):
    """Over a (pod, data) pair of one-rank NCCL groups: hierarchical per
    leaf and bucketed (striped) on the cuda backend equal the flat plain
    aggregation with the same pod-wire shift, bit for bit."""
    import torch.distributed as dist

    from repro_torch.runtime.elastic import make_groups

    assert not dist.is_initialized()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        pair = make_groups(1)
        tree = _tree(dev)
        base = dict(pod_wire_bits=pod_wire)
        want = Aggregator(AggConfig(backend="torch", **base), pair).allreduce_tree(tree)
        for bucket_bytes in (0, 8192):
            got = Aggregator(AggConfig(backend="cuda", bucket_bytes=bucket_bytes, **base),
                             pair).allreduce_tree(tree)
            _same_bits(got, want)
        if pod_wire == 32:  # a pod wire of 32 bits adds no shift: the flat result
            _same_bits(want, Aggregator(AggConfig(backend="torch")).allreduce_tree(tree))
    finally:
        dist.destroy_process_group()


def test_mesh_aggregation_equals_plain(dev, tmp_path):
    """On a ("data", "model") = (1, 1) DeviceMesh over a one-rank NCCL
    group, a smoke model placed by ``sharding.rules.distribute``: the
    mesh step's gradients (DTensor views, ``MeshGrads``) aggregated on the
    cuda backend (K1/K2) equal the plain model's gradients aggregated per
    leaf, bit for bit, and the losses are equal."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.registry import build
    from repro_torch.sharding import hints, rules
    from repro_torch.train.step import MeshGrads, _swapped

    assert not dist.is_initialized()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        cfg = get_smoke_config("qwen1.5-0.5b").with_(param_dtype="bfloat16",
                                                       activation_dtype="bfloat16")
        model = build(cfg, device=dev, seed=0)
        gen = torch.Generator().manual_seed(2)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 64), generator=gen).to(dev)}
        agg = AggConfig(backend="cuda")
        loss = model.loss(batch)
        want = Aggregator(agg).allreduce_tree(
            list(torch.autograd.grad(loss, list(model.parameters()))))
        mesh = make_mesh_for(1)
        rules.distribute(model, cfg, mesh)
        plan = MeshGrads(model, mesh, agg)
        views = plan.views()
        before = _k1k2_launches()
        with _swapped(model, views), hints.use_mesh(mesh), implicit_replication():
            got_loss = model.loss(batch)
            grads = torch.autograd.grad(got_loss, list(views.values()))
        pairs = [plan.local(g, p) for g, p in zip(grads, views.values())]
        got = plan.aggregate([g for g, _ in pairs], [t for _, t in pairs], views)
        assert _k1k2_launches(before) == (0, len(want), len(want), len(want))
        assert torch.equal(got_loss.full_tensor(), loss)
        _same_bits(dict(enumerate(g.full_tensor() for g in got)), dict(enumerate(want)))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# stacked (logical-worker) aggregation and checkpoints on the card
# ---------------------------------------------------------------------------


def _stacked_tree(dev, k):
    """k workers' ragged gradient trees, stacked on a leading worker axis."""
    trees = [_tree(dev) for _ in range(k)]
    for j, t in enumerate(trees):  # distinct workers
        for v in t.values():
            v.mul_(1.0 + j / 8)
    return {name: torch.stack([t[name] for t in trees]) for name in trees[0]}


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("wire", [32, 16, 8])
@pytest.mark.parametrize("fmt", FMTS)
def test_stacked_fpisa_cuda_equals_plain(dev, k, wire, fmt):
    """Stacked fpisa on the cuda backend (K1's exponent and wire modes once
    per leaf over the k workers' rows, the fold in wire mode, K2 once per
    leaf) equals the plain stacked aggregation, per leaf and bucketed, bit
    for bit."""
    tree = _stacked_tree(dev, k)
    base = dict(wire_bits=wire, fmt_name=fmt)
    want = Aggregator(AggConfig(backend="torch", **base), stacked=True).allreduce_tree(tree)
    before = _k1k2_launches()
    got = Aggregator(AggConfig(backend="cuda", **base), stacked=True).allreduce_tree(tree)
    n = len(tree)
    assert _k1k2_launches(before) == (0, n, n, n)
    _same_bits(got, want)
    _same_bits(Aggregator(AggConfig(backend="cuda", bucket_bytes=8192, **base),
                          stacked=True).allreduce_tree(tree), want)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("fmt", FMTS)
def test_stacked_fpisa_seq_cuda_equals_plain(dev, k, fmt):
    """Stacked fpisa_seq: K6's leaf mode once per leaf over the (k, N) stack
    on the cuda backend, fpisa_sum_sequential on torch; the same bits."""
    tree = _stacked_tree(dev, k)
    want = Aggregator(AggConfig(strategy="fpisa_seq", backend="torch", fmt_name=fmt),
                      stacked=True).allreduce_tree(tree)
    before = ops.accum.launches
    got = Aggregator(AggConfig(strategy="fpisa_seq", backend="cuda", fmt_name=fmt),
                     stacked=True).allreduce_tree(tree)
    assert ops.accum.launches - before == len(tree)
    _same_bits(got, want)


def test_checkpoint_round_trip_of_cuda_tensors(dev, tmp_path):
    """bf16 and fp32 CUDA tensors through save / restore: the restored
    leaves land on the like's CUDA device with the same bits."""
    from repro_torch.runtime import checkpoint as ckpt

    tree = {"w": _x((37, 13), "bf16", 1, dev), "m": _x((700,), "fp32", 2, dev),
            "step": 5}
    ckpt.save_bundle(str(tmp_path), 2, {"params": tree})
    like = {"w": torch.empty((37, 13), dtype=torch.bfloat16, device=dev),
            "m": torch.empty(700, device=dev), "step": 0}
    out, _ = ckpt.restore_bundle(str(tmp_path), 2, {"params": like})
    got = out["params"]
    assert got["step"] == 5
    assert got["w"].is_cuda and torch.equal(got["w"].view(torch.int16), tree["w"].view(torch.int16))
    assert got["m"].is_cuda and torch.equal(got["m"].view(torch.int32), tree["m"].view(torch.int32))


def test_reproducible_repeats_the_backward_bits(dev):
    """Inside runtime.elastic.reproducible, two backward passes of the
    smoke model give the same gradient bits; the setting is restored on
    exit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build
    from repro_torch.runtime.elastic import reproducible

    model = build(get_smoke_config("qwen1.5-0.5b"), device=dev)
    tokens = torch.randint(0, 512, (4, 64), device=dev)
    was = torch.are_deterministic_algorithms_enabled()
    with reproducible(dev):
        assert torch.are_deterministic_algorithms_enabled()
        runs = [torch.autograd.grad(model.loss({"tokens": tokens}), list(model.parameters()))
                for _ in range(3)]
    assert torch.are_deterministic_algorithms_enabled() == was
    for r in runs[1:]:
        for a, b in zip(runs[0], r):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _serving_pair(dev, **cfg_kw):
    """The smoke model from one seeded parameter tree, on the CPU and on
    the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer
    from repro_torch.models.registry import build

    cfg = get_smoke_config("qwen1.5-0.5b").with_(**cfg_kw)
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0))
    return (build(cfg, device=torch.device("cpu"), params=params),
            build(cfg, device=dev, params=params))


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_serving_decode_on_the_card_matches_cpu(dev, kv_heads):
    """prefill, decode_step and decode_step_paged on the card against the
    CPU plain path (float32, TF32 off), within 2e-5; on the card paged ==
    dense and a row alone == the row in a batch, bit for bit."""
    from repro_torch.serve.kvcache import PagedKVCache

    cpu_m, card_m = _serving_pair(dev, num_kv_heads=kv_heads)
    prompts = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (3, 10)))
    nxt = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (3, 1)))
    out = {}
    for name, m, d in (("cpu", cpu_m, torch.device("cpu")), ("card", card_m, dev)):
        logits, cache = m.prefill(prompts.to(d), m.init_cache(3, 32))
        paged = PagedKVCache(m.cfg, num_slots=3, max_len=32, page_size=8, device=d)
        for j in range(3):
            paged.grow_slot(j, 11)
            paged.write_prompt(j, cache.kv.k[:, j, :10], cache.kv.v[:, j, :10])
        dense, _ = m.decode_step(nxt.to(d), cache)
        lens = torch.full((3,), 10, device=d)
        pg, _, _ = m.decode_step_paged(nxt.to(d), paged.k, paged.v, paged.device_table(), lens)
        alone, _, _ = m.decode_step_paged(nxt[1:2].to(d), paged.k, paged.v,
                                          paged.device_table()[1:2], lens[1:2])
        out[name] = (logits.cpu(), dense.cpu(), pg.cpu(), alone.cpu())
    for a, b in zip(out["card"], out["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-5)
    _, dense, pg, alone = out["card"]
    assert torch.equal(dense, pg) and torch.equal(alone[0], pg[1])


@pytest.mark.parametrize("strategy, kernel", [("fpisa", "block_max"),
                                              ("fpisa", "encode_wire"),
                                              ("fpisa", "decode_fused"),
                                              ("fpisa_seq", "accum")])
def test_serving_telemetry_launches_the_kernels(dev, strategy, kernel):
    """The continuous engine on the card with ``strategy`` telemetry: one
    launch of the kernel per telemetry flush, exact totals, and the same
    tokens as without telemetry."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.scheduler import ContinuousEngine

    _, card_m = _serving_pair(dev)
    rng = np.random.default_rng(8)
    reqs = [Request(i, rng.integers(0, 512, 5).astype(np.int32), 4) for i in range(5)]
    plain = {r.rid: r.tokens for r in
             ContinuousEngine(card_m, num_slots=2, max_len=16, page_size=8).run(reqs)}
    fn = getattr(ops, kernel)
    before = fn.launches
    eng = ContinuousEngine(card_m, num_slots=2, max_len=16, page_size=8,
                           agg=AggConfig(strategy=strategy))
    res = eng.run(reqs)
    assert fn.launches - before == eng.telemetry_channel.reductions >= 1
    assert eng.telemetry["requests"] == 5 and eng.telemetry["tokens_generated"] == 20
    for r in res:
        np.testing.assert_array_equal(r.tokens, plain[r.rid])


# ---------------------------------------------------------------------------
# non-finite casts, the switch dataplane and the query operators on the card
# ---------------------------------------------------------------------------


def test_nonfinite_casts_on_the_card_equal_the_cpu(dev):
    """The XLA-style casts (NaN -> 0 and saturation to int32; the
    sign-keeping bf16 NaN) give the CPU's bits on the card."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    words[:6] = [0x7FC00000, 0xFFC00000, 0x7F800001, 0x7F800000, 0xFF800000, 0x4F000000]
    x = torch.from_numpy(words.view(np.float32).copy())
    assert torch.equal(nx.f32_to_int32(x.to(dev)).cpu(), nx.f32_to_int32(x))
    assert torch.equal(fpisa.to_packed(x.to(dev), "bf16").cpu().view(torch.int16),
                       fpisa.to_packed(x, "bf16").view(torch.int16))


@pytest.mark.parametrize("strategy,fmt", [("switchml", "fp32"), ("switchml", "bf16"),
                                          ("fpisa", "bf16"), ("fpisa_seq", "bf16")])
def test_nonfinite_aggregation_on_the_card_equals_the_cpu(dev, strategy, fmt):
    x = _x((4, 1000), "fp32", 3, dev)
    x[1, 300], x[2, 600] = float("-nan"), float("inf")
    got = Aggregator(AggConfig(strategy=strategy, fmt_name=fmt)).allreduce(x)
    want = Aggregator(AggConfig(strategy=strategy, fmt_name=fmt, backend="torch")).allreduce(
        x.cpu())
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("variant", ["fpisa_a", "full"])
@pytest.mark.parametrize("pipelines", [1, 3])
def test_batched_dataplane_on_the_card_equals_the_cpu(dev, variant, pipelines):
    from repro_torch import switchsim

    rng = np.random.default_rng(pipelines)
    vec = (rng.standard_normal((4, 3000)) * np.exp2(rng.integers(-12, 12, (4, 3000))))
    vec = vec.astype(np.float32)
    kw = dict(num_workers=4, num_slots=2, elems_per_packet=64, num_pipelines=pipelines,
              variant=variant)
    runs = []
    for d in (dev, "cpu"):
        dp = switchsim.BatchedDataplane(switchsim.DataplaneConfig(**kw), device=d)
        out = switchsim.run_aggregation(dp, vec, drop_prob=0.3, seed=7, fail_worker=1,
                                        fail_round=4)
        runs.append((out, dp.stats, dp.state.exp.device.type))
    np.testing.assert_array_equal(runs[0][0].view(np.int32), runs[1][0].view(np.int32))
    assert runs[0][1] == runs[1][1] and runs[0][2] == "cuda"


def test_multitenant_dataplane_on_the_card_equals_numpy(dev):
    from repro_torch import switchsim

    kw = dict(num_workers=9, num_slots=8, elems_per_packet=64, num_jobs=3,
              job_workers=(4, 4, 1), job_priorities=(1, 0, 0), job_weights=(2, 1, 1))
    rng = np.random.default_rng(5)
    vs = [(rng.standard_normal((w, n)) * 0.01).astype(np.float32)
          for w, n in ((4, 2048), (4, 2048), (1, 512))]
    fb, rb = switchsim.run_multitenant(
        switchsim.BatchedDataplane(switchsim.DataplaneConfig(**kw), device=dev), vs,
        drop_prob=0.2, seed=5)
    fn, rn = switchsim.run_multitenant(switchsim.NumpyDataplane(switchsim.DataplaneConfig(**kw)),
                                       vs, drop_prob=0.2, seed=5)
    for a, b in zip(fb, fn):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert rb == rn


def test_query_operators_on_the_card_equal_the_cpu(dev):
    from repro_torch.db import query as q
    from repro_torch.switchsim import query as swq

    rng = np.random.default_rng(1)
    vals = rng.gamma(2.0, 50.0, 200_000).astype(np.float32)
    keys = rng.integers(0, 64, 200_000)
    t = fpisa.encode(torch.tensor(120.0))
    col = torch.from_numpy(vals)
    assert torch.equal(swq.topn_keep(col.to(dev), t.exp, t.man).cpu(),
                       swq.topn_keep(col, t.exp, t.man))
    np.testing.assert_array_equal(q.TopNPruner(10, device=dev).run(vals, batch=8192),
                                  q.TopNPruner(10, device="cpu").run(vals, batch=8192))
    card, cpu = (q.GroupBySum(64, device=d) for d in (dev, "cpu"))
    assert card.run(keys, vals, batch=16384) == cpu.run(keys, vals, batch=16384)
    for a, b in ((card.exp, cpu.exp), (card.man, cpu.man), (card.since, cpu.since)):
        assert a.is_cuda and torch.equal(a.cpu(), b)


def test_dataplane_and_groupby_on_the_card_under_deterministic_algorithms(dev):
    """The round loops use only ops that deterministic algorithms allow on
    the card (``runtime.elastic.reproducible`` turns them on)."""
    from repro_torch import switchsim
    from repro_torch.db import query as q

    vec = (np.random.default_rng(2).standard_normal((3, 2000)) * 0.1).astype(np.float32)
    kw = dict(num_workers=3, num_slots=2, elems_per_packet=64, num_pipelines=2,
              variant="full")
    want = switchsim.run_aggregation(switchsim.BatchedDataplane(
        switchsim.DataplaneConfig(**kw), device=dev), vec, drop_prob=0.3, seed=2)
    keys = np.random.default_rng(3).integers(0, 8, 3000)
    plain = q.GroupBySum(8, device=dev).run(keys, vec.reshape(-1)[:3000])
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = switchsim.run_aggregation(switchsim.BatchedDataplane(
            switchsim.DataplaneConfig(**kw), device=dev), vec, drop_prob=0.3, seed=2)
        again = q.GroupBySum(8, device=dev).run(keys, vec.reshape(-1)[:3000])
    finally:
        torch.use_deterministic_algorithms(before)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert again == plain


def _family_pair(dev, arch, **cfg_kw):
    """A smoke model of ``arch`` on the CPU and on the card, same weights."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer
    from repro_torch.models.registry import build

    cfg = get_smoke_config(arch).with_(**cfg_kw)
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0))
    return (build(cfg, device=torch.device("cpu"), params=params),
            build(cfg, device=dev, params=params))


def test_gqa_ratio_seven_on_the_card_matches_cpu(dev):
    """g = 7 (arctic's and llava's 56 / 8; here 14 heads / 2 KV heads at
    head_dim 8): the loss and every gradient within 2e-5 of the CPU's
    (relative to each leaf's largest |entry|), prefill, decode and paged
    decode logits within 2e-5; on the card paged == dense bit for bit."""
    from repro_torch.serve.kvcache import PagedKVCache

    cpu_m, card_m = _family_pair(dev, "internlm2-20b", num_heads=14, num_kv_heads=2,
                                 d_model=112)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (2, 64)))
    nxt = torch.from_numpy(np.random.default_rng(6).integers(0, 512, (2, 1)))
    out = {}
    for name, m, d in (("cpu", cpu_m, torch.device("cpu")), ("card", card_m, dev)):
        loss = m.loss({"tokens": tokens.to(d)})
        grads = torch.autograd.grad(loss, list(m.parameters()))
        logits, cache = m.prefill(tokens.to(d), m.init_cache(2, 80))
        paged = PagedKVCache(m.cfg, num_slots=2, max_len=80, page_size=8, device=d)
        for j in range(2):
            paged.grow_slot(j, 65)
            paged.write_prompt(j, cache.kv.k[:, j, :64], cache.kv.v[:, j, :64])
        dense, _ = m.decode_step(nxt.to(d), cache)
        pg, _, _ = m.decode_step_paged(nxt.to(d), paged.k, paged.v, paged.device_table(),
                                       torch.full((2,), 64, device=d))
        out[name] = ([loss.detach()] + [g.cpu() for g in grads], (logits.cpu(), dense.cpu(),
                                                                  pg.cpu()))
    for a, b in zip(out["card"][0], out["cpu"][0]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=2e-5 * float(b.abs().max()))
    for a, b in zip(out["card"][1], out["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-5)
    assert torch.equal(out["card"][1][1], out["card"][1][2])


def test_moe_overflow_on_the_card_equals_the_cpu(dev):
    """F10 on CUDA: 64 tokens all routed to expert 0 of 4 (top-1, capacity
    24): the slot table, the overflow flags and the set of tokens served
    (0..22) equal the CPU's exactly, the outputs within 1e-5 of the
    largest; a scatter with duplicate indices decides nothing."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    cfg = get_smoke_config("arctic-480b").with_(num_experts=4, num_experts_per_token=1,
                                                moe_group_size=64)
    p = moe.init_moe(torch.Generator().manual_seed(1), cfg)
    p["router"].zero_()
    p["router"][0, 0] = 50.0
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 64, cfg.d_model))
                         .astype(np.float32))
    x[..., 0] = x[..., 0].abs() + 1.0
    got = {}
    for d in (torch.device("cpu"), dev):
        pd = {k: v.to(d) for k, v in p.items()}
        out, _ = moe.apply_moe(pd, x.to(d), cfg)
        r = moe.route(pd, x.to(d), cfg)
        got[d.type] = (out.cpu(), r.slot_tok.cpu(), r.overflow.cpu())
    (co, cs, cf), (go, gs, gf) = got["cpu"], got["cuda"]
    assert torch.equal(cs, gs) and torch.equal(cf, gf)
    served = lambda o: torch.nonzero(o[0].abs().amax(-1) > 0).flatten().tolist()  # noqa: E731
    assert served(go) == served(co) == list(range(23))
    np.testing.assert_allclose(go.numpy(), co.numpy(), rtol=0,
                               atol=1e-5 * float(co.abs().max()))


def test_ssd_decode_continues_prefill_on_the_card(dev):
    """mamba2-780m at smoke size on the card: prefill of 48 tokens, then one
    decode step (the recurrence), gives the last logits of a prefill of the
    49 tokens (the chunked scan) within 2e-5 of their largest |logit|; the
    SSM states within 1e-5 of the largest; and the decode logits equal the
    CPU's within 2e-5."""
    cpu_m, card_m = _family_pair(dev, "mamba2-780m")
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 512, (2, 49)))
    out = {}
    for name, m, d in (("cpu", cpu_m, torch.device("cpu")), ("card", card_m, dev)):
        _, cache = m.prefill(tokens[:, :48].to(d), m.init_cache(2, 64))
        step, cache = m.decode_step(tokens[:, 48:].to(d), cache)
        full, whole = m.prefill(tokens.to(d), m.init_cache(2, 64))
        out[name] = step.cpu()
        if name == "card":
            np.testing.assert_allclose(step.cpu().numpy(), full.cpu().numpy(), rtol=0,
                                       atol=2e-5 * float(full.abs().max()))
            want = whole.ssm[:, :2].cpu()
            np.testing.assert_allclose(cache.ssm[:, :2].cpu().numpy(), want.numpy(), rtol=0,
                                       atol=1e-5 * float(want.abs().max()))
    np.testing.assert_allclose(out["card"].numpy(), out["cpu"].numpy(), rtol=0, atol=2e-5)


def test_encoder_decoder_on_the_card_matches_cpu(dev):
    """whisper-medium at smoke size (2 + 2 layers, 24 frames) on the card:
    the loss and every gradient within 2e-5 of the CPU's (relative to each
    leaf's largest |entry|); prefill of 16 tokens and 4 decode steps (the
    prompt's next tokens) with logits within 2e-5 of the CPU's, the cross
    K/V within 1e-6."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import encdec
    from repro_torch.models.registry import build

    cfg = get_smoke_config("whisper-medium")
    params = encdec.init_encdec(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    frames = torch.from_numpy(rng.standard_normal((2, cfg.num_frames, cfg.d_model))
                              .astype(np.float32))
    out = {}
    for d in (torch.device("cpu"), dev):
        m = build(cfg, device=d, params=params)
        batch = {"tokens": tokens.to(d), "frames": frames.to(d)}
        loss = m.loss(batch)
        grads = [loss.detach()] + list(torch.autograd.grad(loss, list(m.parameters())))
        logits, cache = m.prefill(batch["tokens"][:, :16], m.init_cache(2, 24), batch["frames"])
        served = [logits]
        for t in range(16, 20):
            logits, cache = m.decode_step(batch["tokens"][:, t:t + 1], cache)
            served.append(logits)
        out[d.type] = ([g.cpu() for g in grads], [s.cpu() for s in served],
                       [c.cpu() for c in cache.cross_kv])
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2e-5 * float(b.abs().max()))
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-5)
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


# --- S1: Mamba2's chunked SSD scan ------------------------------------------

# (B, S, H, P, G, N, chunk, dtype): zamba2-7b's training shape (the cell
# zamba2_train_4k), mamba2-780m's ([models] (a): 8 x 512, N 128), a chunk
# that is not a multiple of the kernels' 64-row tiles (100: a full and a
# masked tile) in float32, and a batch-1 prefill whose chunk halves to 8
S1_CASES = {"zamba2": (4, 4096, 112, 64, 2, 64, 256, torch.bfloat16),
            "mamba2_780m": (8, 512, 48, 64, 1, 128, 256, torch.bfloat16),
            "ragged": (2, 300, 8, 64, 2, 64, 100, torch.float32),
            "prefill": (1, 1000, 48, 64, 1, 128, 256, torch.bfloat16)}
# dt's two regimes: "init", log-uniform over Mamba2's initial range [1e-3,
# 0.1], where the state a chunk carries and the tiles far from the diagonal
# weigh in the result at 256-row chunks; "softplus", softplus of a normal
# (about 0.8), where most of a chunk's decay underflows to 0 in float32
S1_DT = ("init", "softplus")


def _s1_inputs(case, dev, seed=0, dt_regime="init"):
    """x, B and C as views of one (B, S, H P + 2 G N) row, as the block's
    projection split hands them; dt in ``dt_regime`` (``S1_DT``), A the
    model's -[1 .. 16]; dy and the final state's gradient."""
    b, s, h, p, g, n, _, dtype = S1_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(seed)
    wide = torch.randn(b, s, h * p + 2 * g * n, device=dev, generator=gen).to(dtype)
    x = wide[..., :h * p].unflatten(-1, (h, p))
    bm = wide[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cm = wide[..., h * p + g * n:].unflatten(-1, (g, n))
    if dt_regime == "init":
        u = torch.rand(b, s, h, device=dev, generator=gen)
        dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
    else:
        dt = torch.nn.functional.softplus(torch.randn(b, s, h, device=dev, generator=gen))
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    d = torch.randn(h, device=dev, generator=gen)
    dy = torch.randn(b, s, h, p, device=dev, generator=gen).to(dtype)
    dfin = torch.randn(b, h, p, n, device=dev, generator=gen)
    return (x, dt, a, bm, cm, d), dy, dfin


@pytest.mark.parametrize("case", list(S1_CASES))
def test_s1_matches_the_plain_version(dev, case):
    """S1 (``kernels/ssd.py`` through ``models.mamba2.ssd_chunked``) against
    the plain version in float64 on the same inputs (``ssd_float64_ref``),
    in both of dt's regimes: the final state, ddt, dA and dD within 1e-5 of
    their largest |entry|; y, dx, dB and dC within one rounding to the
    inputs' dtype (2^-8 of the largest |entry| for bfloat16, 1e-5 for
    float32). The gradients are those of sum(y dy) + sum(final dfinal). The
    launch counters move by one each a call."""
    from repro_torch.kernels import ssd
    from repro_torch.models import mamba2

    chunk, dtype = S1_CASES[case][6], S1_CASES[case][7]
    loose = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    names = ("y", "final", "dx", "ddt", "dA", "dB", "dC", "dD")
    tols = (loose, 1e-5, loose, 1e-5, 1e-5, loose, loose, 1e-5)
    for regime in S1_DT:
        args, dy, dfin = _s1_inputs(case, dev, dt_regime=regime)
        want_y, want_fin, want_grads = ssd.ssd_float64_ref(*args, chunk, dy, dfin)
        leaves = [t.detach().requires_grad_() for t in args]
        f0, b0 = ssd.ssd_forward.launches, ssd.ssd_backward.launches
        y, fin = mamba2.ssd_chunked(*leaves, chunk)
        got_grads = torch.autograd.grad((y.float() * dy.float()).sum() + (fin * dfin).sum(),
                                        leaves)
        torch.cuda.synchronize()
        assert (ssd.ssd_forward.launches - f0, ssd.ssd_backward.launches - b0) == (1, 1)
        assert y.dtype == dtype and fin.dtype == torch.float32
        for name, tol, got, want in zip(names, tols, (y, fin, *got_grads),
                                        (want_y, want_fin, *want_grads)):
            err = float((got.detach().double() - want).abs().max() / want.abs().max())
            assert err <= tol, (f"{case}, dt {regime}, {name}: {err:.3e} of the largest "
                                f"|entry| (limit {tol:.1e})")
        del args, dy, dfin, want_y, want_fin, want_grads, leaves, y, fin, got_grads
        torch.cuda.empty_cache()


def test_s1_takes_bf16_a_and_d_skip(dev):
    """A model whose leaves are all bfloat16 hands S1 a and d_skip in
    bfloat16: the result is the float32 call's on the same values, bit for
    bit, and their gradients are the float32 call's cast to bfloat16 (the
    plain version's type promotion)."""
    from repro_torch.models import mamba2

    args, dy, _ = _s1_inputs("prefill", dev, seed=3)
    x, dt, a, bm, cm, d = args
    a16, d16 = a.to(torch.bfloat16), d.to(torch.bfloat16)
    outs = []
    for aa, dd in ((a16, d16), (a16.float(), d16.float())):
        leaves = [t.detach().requires_grad_() for t in (x, dt, aa, bm, cm, dd)]
        y, fin = mamba2.ssd_chunked(*leaves, S1_CASES["prefill"][6])
        outs.append((y, fin, torch.autograd.grad((y.float() * dy.float()).sum(), leaves)))
    (y16, f16, g16), (y32, f32, g32) = outs
    assert torch.equal(y16, y32) and torch.equal(f16, f32)
    assert g16[2].dtype == g16[5].dtype == torch.bfloat16
    for got, want in zip(g16, g32):
        assert torch.equal(got, want.to(got.dtype))


def test_s1_refuses_what_it_does_not_take(dev):
    """A CUDA call the kernels do not take raises ValueError: head_dim past
    64, a chunk past 256, float16, a CPU operand beside CUDA ones."""
    from repro_torch.models import mamba2

    def call(p=64, chunk=256, s=512, dtype=torch.bfloat16, dt_dev=dev):
        x = torch.zeros(1, s, 4, p, device=dev, dtype=dtype)
        bm = torch.zeros(1, s, 1, 64, device=dev, dtype=dtype)
        dt = torch.ones(1, s, 4, device=dt_dev)
        a, d = -torch.ones(4, device=dev), torch.ones(4, device=dev)
        return mamba2.ssd_chunked(x, dt, a, bm, bm, d, chunk)

    call()
    for kwargs, match in (({"p": 128}, "head_dim"), ({"chunk": 512}, "chunks of at most"),
                          ({"dtype": torch.float16}, "x must be"),
                          ({"dt_dev": torch.device("cpu")}, "CUDA tensor")):
        with pytest.raises(ValueError, match=match):
            call(**kwargs)


# --- A1: the chunked (online-softmax) attention kernel ---------------------

# (B, S, Sk, H, K, hd, q_chunk, causal): chip_smoke.py's [longctx] (a) shapes
# (qwen: 16 heads of 64, batch 2, cq = 32), then the configs' other cases:
# the full configs' chunk 2048 (32 key tiles a chunk, the online update
# inside it), whisper's 1500 frames (one ragged block) and its 448-token
# cross-attention, GQA g = 7 at head_dim 128 (K/V repeated before the
# launch) with the halving fallback (chunks of 16), zamba2's head_dim 112,
# stablelm's 80 (chunks of 8)
A1_CASES = [(2, s, s, 16, 16, 64, 32, c) for s in (512, 1024, 4096) for c in (True, False)] + [
    (1, 4096, 4096, 4, 4, 64, 2048, True), (1, 1500, 1500, 4, 4, 64, 2048, False),
    (2, 448, 1500, 4, 4, 64, 2048, False), (2, 80, 80, 14, 2, 128, 32, True),
    (2, 256, 256, 4, 4, 112, 32, True), (1, 40, 40, 4, 4, 80, 32, True)]
# kernel against the plain version on the same card tensors, relative to the
# plain result's largest |entry|: float32 (the CUDA-core kernels) differs
# only in the order of the float32 additions; bfloat16 (the tensor-core
# kernels) rounds where the plain version does (the scores, p before p.v,
# each chunk's p.v, and in the backward P and dS as product operands, dP and
# D staying float32), so it differs where such a rounding falls the other
# way after a different order of additions, most in dq without the causal
# mask, whose dS = P (dP - D) subtracts near equals (measured on an H100
# 80GB HBM3 at 700 W: float32 at most 3.1e-6; bf16 output at most 7.58e-3,
# gradients at most 3.08e-2, where the kernel's dq is 1.16e-2 from the plain
# version in float32 and the plain bf16 dq 2.40e-2; chip_smoke.py prints
# each against float32)
A1_TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (1e-2, 6e-2)}  # (output, gradients)


def _a1_inputs(case, dtype, dev, seed=0):
    b, s, sk, h, kvh, hd = case[:6]
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
                     .to(dtype) for shape in ((b, s, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd),
                                              (b, s, h, hd)))
    return q, k, v, dout


def _a1_run(fn, q, k, v, dout):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    return [out.detach()] + list(torch.autograd.grad(out, (q, k, v), dout))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", A1_CASES, ids=lambda c: "b{}_s{}_sk{}_h{}_k{}_d{}_c{}_{}".format(
    *c[:7], "causal" if c[7] else "full"))
def test_chunked_attention_kernel_equals_plain(dev, case, dtype):
    """A1's output and q/k/v gradients (its recomputing backward) against
    the plain loop on the same CUDA tensors, within ``A1_TOL``; the kernel
    launches once forward and once backward."""
    from repro_torch.kernels import attention

    causal, q_chunk = case[7], case[6]
    q, k, v, dout = _a1_inputs(case, dtype, dev)
    cq, ck = attention.chunk_sizes(q.shape[1], k.shape[1], q_chunk)
    before = (attention.attention_forward.launches, attention.attention_backward.launches)
    got = _a1_run(lambda *t: ops.chunked_attention(*t, causal=causal, cq=cq, ck=ck), q, k, v,
                  dout)
    assert (attention.attention_forward.launches, attention.attention_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    want = _a1_run(lambda *t: attention.chunked_attention_ref(
        *t, causal=causal, cq=cq, ck=ck, remat_step=False), q, k, v, dout)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        tol = A1_TOL[dtype][min(i, 1)] * float(b.abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol, (["out", "dq", "dk", "dv"][i], err, tol)


# bf16 only (the tensor-core kernels' edges): query tiles that end inside the
# 128-row CTA tile (S = 200, 1500), chunks narrower than the 64-key tile (ck =
# 8 at S = 3000; ck = 1, odd, from the halving at a serving-like 333; ck = 77,
# odd and one tile and a ragged one wide), head_dim 80, 112 and 128 (the
# second instantiation, zeros past hd from TMA) over two chunks of 2048,
# whisper's 448 x 1500 cross-attention at its batch and heads, and keys and
# query rows that end inside the backward's 128-key CTA (S = 4,000 and 192
# causal: the CTA's second warpgroup without a key; Sk = 1,000 not causal:
# 40 keys in it; S = 448: a dQ warpgroup without a row)
A1_BF16_CASES = [
    (2, 200, 200, 4, 4, 64, 2048, True), (1, 1500, 1500, 4, 4, 64, 2048, True),
    (1, 3000, 3000, 2, 2, 64, 2048, True), (2, 333, 333, 2, 2, 64, 32, True),
    (2, 77, 77, 2, 2, 64, 2048, True)] + [
    (1, 4096, 4096, 2, 2, hd, 2048, True) for hd in (80, 112, 128)] + [
    (8, 448, 1500, 16, 16, 64, 2048, False), (1, 4000, 4000, 2, 2, 64, 2048, True),
    (2, 192, 192, 4, 4, 64, 2048, True), (2, 448, 1000, 4, 4, 64, 2048, False)]
# (case, dtype) for the bit-for-bit tests: one causal and one not, each dtype,
# and a causal bf16 case whose keys span several of the backward's 128-key CTAs
A1_BITS_CASES = [(c, d) for c in ((4, 200, 200, 4, 4, 64, 32, True),
                                  (4, 448, 1500, 4, 4, 64, 2048, False))
                 for d in (torch.float32, torch.bfloat16)] + [
    ((2, 1000, 1000, 4, 4, 64, 2048, True), torch.bfloat16)]


def _a1_case_id(c):
    return "b{}_s{}_sk{}_h{}_k{}_d{}_c{}_{}".format(*c[:7], "causal" if c[7] else "full")


@pytest.mark.parametrize("case", A1_BF16_CASES, ids=_a1_case_id)
def test_chunked_attention_bf16_kernel_edges_equal_plain(dev, case):
    """The bf16 tensor-core kernels at their tiles' edges against the plain
    loop, within ``A1_TOL``, as ``test_chunked_attention_kernel_equals_plain``."""
    test_chunked_attention_kernel_equals_plain(dev, case, torch.bfloat16)


def _a1_kernel_grads(case, dtype, dev, batch=None):
    from repro_torch.kernels import attention

    causal, q_chunk = case[7], case[6]
    q, k, v, dout = _a1_inputs(case, dtype, dev)
    if batch is not None:
        q, k, v, dout = (t[batch] for t in (q, k, v, dout))
    cq, ck = attention.chunk_sizes(q.shape[1], k.shape[1], q_chunk)
    return _a1_run(lambda *t: ops.chunked_attention(*t, causal=causal, cq=cq, ck=ck), q, k, v,
                   dout)


@pytest.mark.parametrize("case,dtype", A1_BITS_CASES,
                         ids=lambda x: str(x) if isinstance(x, torch.dtype) else _a1_case_id(x))
def test_chunked_attention_kernel_repeats_its_bits(dev, case, dtype):
    """The same inputs through A1 twice: output and q/k/v gradients bit for
    bit (no atomics; every output element has one owner)."""
    first, second = _a1_kernel_grads(case, dtype, dev), _a1_kernel_grads(case, dtype, dev)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case,dtype", A1_BITS_CASES,
                         ids=lambda x: str(x) if isinstance(x, torch.dtype) else _a1_case_id(x))
def test_chunked_attention_row_is_batch_invariant(dev, case, dtype):
    """Each batch row of a B = 4 call equals the same row run alone at B = 1,
    bit for bit, forward and gradients: a row's result depends on its own
    q row, K/V and (causal, ck) only."""
    full = _a1_kernel_grads(case, dtype, dev)
    for r in range(case[0]):
        alone = _a1_kernel_grads(case, dtype, dev, batch=slice(r, r + 1))
        torch.cuda.synchronize()
        for name, a, b in zip(("out", "dq", "dk", "dv"), full, alone):
            assert torch.equal(a[r:r + 1], b), (r, name)


# Zamba2's shared-block attention: 32 heads of 224 (past 128: the "wide"
# kernels), causal, the scores scaled by (224 / 2)^-0.5 rather than
# 224^-0.5; at 1 x 512 (one chunk of 512) and at the benchmark's 4 x 4,096
# (chunks of 2,048)
ZAMBA2_SCALE = (224 / 2) ** -0.5
A1_WIDE_CASES = [(1, 512, 512, 32, 32, 224, 2048, True), (4, 4096, 4096, 32, 32, 224, 2048, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", A1_WIDE_CASES, ids=_a1_case_id)
def test_chunked_attention_wide_kernel_equals_plain(dev, case, dtype):
    """A1 at head_dim 224 with Zamba2's scale: output and q/k/v gradients
    against the plain loop at the same scale, within ``A1_TOL``; one forward
    and one backward launch, and the scale reaches the kernel (the default
    scale's output differs)."""
    from repro_torch.kernels import attention

    causal, q_chunk = case[7], case[6]
    q, k, v, dout = _a1_inputs(case, dtype, dev)
    cq, ck = attention.chunk_sizes(q.shape[1], k.shape[1], q_chunk)
    before = (attention.attention_forward.launches, attention.attention_backward.launches)
    got = _a1_run(lambda *t: ops.chunked_attention(*t, causal=causal, cq=cq, ck=ck,
                                                   scale=ZAMBA2_SCALE), q, k, v, dout)
    assert (attention.attention_forward.launches, attention.attention_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    want = _a1_run(lambda *t: attention.chunked_attention_ref(
        *t, causal=causal, cq=cq, ck=ck, remat_step=False, scale=ZAMBA2_SCALE), q, k, v, dout)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        tol = A1_TOL[dtype][min(i, 1)] * float(b.abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol, (["out", "dq", "dk", "dv"][i], err, tol)
    plain_scale = ops.chunked_attention(q, k, v, causal=causal, cq=cq, ck=ck)
    assert not torch.equal(plain_scale, got[0])


def test_chunked_attention_wide_kernels_do_not_spill(dev):
    """``kernel_info()``: the hd-224 kernels (256 threads, one CTA an SM)
    spill nothing to local memory, and neither do the backward's hd <= 128
    kernels."""
    from repro_torch.kernels import attention

    info = attention.kernel_info()
    for name in ("attn_fwd_tc_wide", "attn_bwd_dq_tc_wide", "attn_bwd_dkv_tc_wide"):
        assert info[name]["threads"] == 256 and info[name]["ctas_per_sm"] == 1, (name, info[name])
        assert info[name]["local_bytes"] == 0, (name, info[name])
    for name in ("attn_bwd_dq_tc<1>", "attn_bwd_dkv_tc<1>", "attn_bwd_dq_tc<2>",
                 "attn_bwd_dkv_tc<2>"):
        assert info[name]["local_bytes"] == 0, (name, info[name])


def test_chunked_attention_kernel_names_keep_the_benchmark_contract(dev):
    """Under ``torch.profiler``, one bf16 forward and one backward call (1 x
    512, 4 heads of 64, causal) launch only kernels whose names hold
    ``attn_fwd`` or ``attn_bwd``, one forward kernel and exactly one whose
    name holds ``attn_bwd_dq``: ``fpisa_bench/metrics/a1_roofline.py`` counts
    the backward calls by that name."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import attention

    q, k, v, dout = _a1_inputs((1, 512, 512, 4, 4, 64), torch.bfloat16, dev)
    out, m, l = attention.attention_forward(q, k, v, True, 512)
    attention.attention_backward(q, k, v, out, dout, m, l, True)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, m, l = attention.attention_forward(q, k, v, True, 512)
        attention.attention_backward(q, k, v, out, dout, m, l, True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("attn_fwd" in n or "attn_bwd" in n for n in names), names
    assert sum("attn_fwd" in n for n in names) == 1, names
    assert sum("attn_bwd_dq" in n for n in names) == 1, names


def test_chunked_attention_kernel_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels import attention

    q = torch.zeros((1, 64, 2, 64), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        attention.attention_forward(q.half(), q.half(), q.half(), True, 32)
    with pytest.raises(ValueError, match="head_dim"):  # past MAX_HEAD_DIM, 256
        z = torch.zeros((1, 64, 2, 264), device=dev)
        attention.attention_forward(z, z, z, True, 32)
    with pytest.raises(ValueError, match="S == Sk"):
        attention.attention_forward(q, q[:, :32], q[:, :32], True, 32)
    with pytest.raises(ValueError, match=r"\(B, Sk, H, hd\)"):
        attention.attention_forward(q, q[:, :, :1], q[:, :, :1], True, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention.attention_forward(q.cpu(), q.cpu(), q.cpu(), True, 32)
    with pytest.raises(ValueError, match="divide"):
        attention.attention_forward(q, q, q, False, 48)
    # bf16 goes through TMA: rows of 16-byte multiples, 16-byte aligned bases
    with pytest.raises(ValueError, match="multiple of 8"):
        z = torch.zeros((1, 64, 2, 36), device=dev, dtype=torch.bfloat16)
        attention.attention_forward(z, z, z, True, 32)
    with pytest.raises(ValueError, match="16-byte boundary"):
        z = torch.zeros(1 * 64 * 2 * 64 + 1, device=dev, dtype=torch.bfloat16)[1:]
        z = z.view(1, 64, 2, 64)
        attention.attention_forward(z, z, z, True, 32)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "arctic-480b", "mamba2-780m", "zamba2-7b",
                                  "llava-next-34b"])
def test_remat_dots_on_the_card_gives_the_bits_of_full(dev, arch):
    """``remat="dots"`` (selective checkpointing) on the card at smoke size,
    bf16, inside ``runtime.elastic.reproducible``: the loss and every
    gradient equal ``"full"``'s bit for bit, and A1 launches as under
    ``"full"`` (its forward is replayed by the recompute: twice per
    attention layer, the backward once)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import attention
    from repro_torch.models.registry import build
    from repro_torch.runtime.elastic import reproducible

    cfg = get_smoke_config(arch).with_(param_dtype="bfloat16", activation_dtype="bfloat16")
    rng = np.random.default_rng(21)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))).to(dev)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32)).to(dev)
    runs, a1 = {}, {}
    with reproducible(dev):
        for mode in ("full", "dots"):
            model = build(cfg.with_(remat=mode), device=dev, seed=0)
            before = (attention.attention_forward.launches, attention.attention_backward.launches)
            loss = model.loss(batch)
            runs[mode] = [loss] + list(torch.autograd.grad(loss, list(model.parameters())))
            a1[mode] = (attention.attention_forward.launches - before[0],
                        attention.attention_backward.launches - before[1])
    assert a1["dots"] == a1["full"]
    assert a1["full"][0] == 2 * a1["full"][1] and (a1["full"][1] > 0) == (cfg.family != "ssm")
    ints = {4: torch.int32, 2: torch.int16}
    for a, b in zip(runs["full"], runs["dots"]):
        assert a.dtype == b.dtype and torch.equal(a.view(ints[a.element_size()]),
                                                  b.view(ints[b.element_size()]))


TRAIN_PHASES = ["train.forward_backward", "agg.allreduce_tree", "train.optimizer"]


@pytest.fixture
def qwen_step(dev):
    """qwen1.5-0.5b at full width cut to 4 layers (bf16), its train step
    (``fpisa`` on the cuda backend) warmed once, the optimizer state and a
    2 x 2,048-token batch."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    from repro_torch.optim import optimizers
    from repro_torch.train.step import make_train_step

    cfg = get_config("qwen1.5-0.5b").with_(num_layers=4)
    model = build(cfg, device=dev, seed=0)
    opt_cfg = optimizers.OptConfig()
    step = make_train_step(model, AggConfig(strategy="fpisa", backend="auto"), opt_cfg, 2)
    state = optimizers.init(list(model.parameters()), opt_cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2048), device=dev, generator=gen)}
    step(state, batch)
    torch.cuda.synchronize()
    return step, state, batch


def test_train_step_phases_tile_the_step_on_the_card(qwen_step):
    """The tracer's device intervals (CUDA events, no wait) of a step's
    three phases come in order inside ``train.step``'s, do not overlap, and
    sum to within 5 % of the step's synchronized wall time, in each of 3
    traced steps."""
    import time

    from repro_torch import trace

    step, state, batch = qwen_step
    tr = trace.enable()
    walls = []
    try:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        trace.disable()
    spans = tr.spans
    tops = [s for s in spans if s["name"] == "train.step"]
    assert len(tops) == 3
    eps = 1e-6  # the events' resolution, in seconds
    for top, wall in zip(tops, walls):
        kids = sorted((s for s in spans if s["parent"] == top["id"]),
                      key=lambda s: s["dev_ts"])
        assert [s["name"] for s in kids] == TRAIN_PHASES
        for a, b in zip(kids, kids[1:]):
            assert a["dev_ts"] + a["dev_dur"] <= b["dev_ts"] + eps
        assert top["dev_ts"] <= kids[0]["dev_ts"] + eps
        assert kids[-1]["dev_ts"] + kids[-1]["dev_dur"] <= top["dev_ts"] + top["dev_dur"] + eps
        covered = sum(s["dev_dur"] for s in kids)
        assert abs(covered / wall - 1) <= 0.05, (covered, wall)


def test_train_step_phases_in_the_profiler_and_on_the_device_row(qwen_step, tmp_path):
    """One profiled step on the card: the step and its phases are host
    ranges of the profiler's trace; the ranges that launch device work
    themselves (forward+backward, the optimizer, the aggregation's per-leaf
    ``agg.allreduce``) are GPU user annotations too (the profiler gives a
    launch to its innermost range, so ``train.step`` and
    ``agg.allreduce_tree``, whose launches all lie in their children, show
    there through them); the tracer's chrome export draws all four on its
    device row."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace

    step, state, batch = qwen_step
    names = {"train.step", *TRAIN_PHASES}
    tr = trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, batch)
            torch.cuda.synchronize()
    finally:
        trace.disable()
    prof.export_chrome_trace(str(tmp_path / "p.json"))
    events = json.load(open(tmp_path / "p.json"))["traceEvents"]
    assert names <= {e["name"] for e in events if e.get("cat") == "user_annotation"}
    gpu = {e["name"] for e in events if e.get("cat") == "gpu_user_annotation"}
    assert {"train.forward_backward", "train.optimizer", "agg.allreduce"} <= gpu
    doc = trace.to_chrome(tr)
    device = {e["name"] for e in doc["traceEvents"]
              if e["ph"] == "X" and e["pid"] == trace.export.DEVICE_PID}
    assert names <= device
