"""The port's CUDA kernels on the card: K1 (fpisa_encode_align) and K2
(fpisa_decode_fused) against their plain PyTorch versions on the same CUDA
tensors, bit for bit (integer views), over the CPU suite's sweep plus the
special values. These tests need an NVIDIA GPU and nvcc; elsewhere they
skip. They import nothing of JAX, so the GPU machine runs them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fpisa  # noqa: E402
from repro_torch.core import numerics as nx  # noqa: E402
from repro_torch.core.allreduce import _wire_shift  # noqa: E402
from repro_torch.core.agg import AggConfig, Aggregator  # noqa: E402
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
