"""The port's chunked (online-softmax) attention against the reference's
``repro.models.attention.chunked_attention`` on the CPU, where the port
runs its plain loop (``kernels/attention.py::chunked_attention_ref``; A1,
its CUDA kernel, is held to that loop in ``test_torch_cuda.py``). The same
numpy inputs from a seed go to both; the gradients are of the same
cotangent.

* causal and non-causal self-attention, S == Sk at q_chunk 32 with S in
  {32, 80, 96, 128, 256} (the one-block branch at 32, the halving
  fallback to chunks of 16 at 80), and cross-attention lengths S != Sk
  (48 x 100: chunks of 16 against chunks of 4);
* grouped K/V heads (K = H / 2) and K/V repeated to every head, as the
  models call it;
* float32 and bfloat16, ``remat_step`` on and off;
* smoke qwen1.5-0.5b and whisper-medium at ``attn_q_chunk=32`` over
  several chunks (128 tokens, 96 frames): loss and every gradient.

Tolerances, relative to the reference's largest |entry| of each output and
gradient: float32 2e-6 (summation order and transcendentals differ between
the frameworks, the chunking and its order of additions do not); bfloat16
1e-2 for the output and 2e-2 for gradients (a score or a chunk's p.v that
rounds to bf16 the other way moves its row by a bf16 step, and the two
autodiffs round their bf16 products at different points). The models: the
parity harness's 2e-5 (``torch_model_parity.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from torch_model_parity import check_forward_and_grads, make_batch, pair  # noqa: E402

H, HD = 4, 16
LENGTHS = [(32, 32), (80, 80), (96, 96), (128, 128), (256, 256)]
CROSS = [(64, 96), (96, 256), (32, 128), (48, 100)]
CASES = [(s, sk, True) for s, sk in LENGTHS] + [(s, sk, False) for s, sk in LENGTHS + CROSS]
TOL = {"float32": (2e-6, 2e-6), "bfloat16": (1e-2, 2e-2)}  # (output, gradients)


def _inputs(s, sk, kvh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((2, s, H, HD), (2, sk, kvh, HD), (2, sk, kvh, HD), (2, s, H, HD))]


@functools.lru_cache(maxsize=None)
def _reference(s, sk, causal, kvh, dtype):
    """The reference's output and q/k/v gradients, as float32 numpy."""
    q, k, v, dout = (jnp.asarray(a, dtype) for a in _inputs(s, sk, kvh, dtype))

    def fn(q, k, v):
        return jattn.chunked_attention(q, k, v, causal=causal, q_chunk=32, num_kv_heads=kvh)

    out, vjp = jax.vjp(fn, q, k, v)
    return [np.asarray(t, np.float32) for t in (out, *vjp(dout))]


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", ["grouped", "repeated"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "s{}_sk{}_{}".format(
    c[0], c[1], "causal" if c[2] else "full"))
def test_chunked_attention_equals_reference(case, kv, dtype, remat):
    s, sk, causal = case
    kvh = H // 2 if kv == "grouped" else H
    q, k, v, dout = (torch.from_numpy(a).to(getattr(torch, dtype))
                     for a in _inputs(s, sk, kvh, dtype))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tattn.chunked_attention(q, k, v, causal=causal, q_chunk=32, num_kv_heads=kvh,
                                  remat_step=remat)
    got = [out] + list(torch.autograd.grad(out, (q, k, v), dout))
    want = _reference(s, sk, causal, kvh, dtype)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == getattr(torch, dtype) and a.shape == b.shape
        np.testing.assert_allclose(a.detach().float().numpy(), b, rtol=0,
                                   atol=TOL[dtype][min(i, 1)] * np.abs(b).max(),
                                   err_msg=["out", "dq", "dk", "dv"][i])


def test_repeated_heads_equal_grouped_heads():
    """K/V repeated to every head (``num_kv_heads=H``, as the models call
    it) gives the grouped call's output bit for bit: query head h reads kv
    head h // g either way."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(96, 96, H // 2, "float32"))
    grouped = tattn.chunked_attention(q, k, v, causal=True, q_chunk=32, num_kv_heads=H // 2)
    k2, v2 = k.repeat_interleave(2, dim=2), v.repeat_interleave(2, dim=2)
    repeated = tattn.chunked_attention(q, k2, v2, causal=True, q_chunk=32, num_kv_heads=H)
    assert torch.equal(grouped, repeated)


@pytest.mark.parametrize("s, sk, q_chunk, want", [
    (32, 32, 32, (32, 32)), (96, 96, 32, (32, 32)), (100, 100, 32, (4, 4)),
    (1500, 1500, 2048, (1500, 1500)), (448, 1500, 32, (32, 4)), (24, 24, 32, (24, 24)),
    (4096, 4096, 2048, (2048, 2048))])
def test_chunk_sizes_are_the_references(s, sk, q_chunk, want):
    """cq and ck: ``min(q_chunk, length)``, halved until each divides its
    length (the reference's ``:76-83``)."""
    assert kattn.chunk_sizes(s, sk, q_chunk) == want


def test_the_plain_loop_holds_one_chunk_column_of_scores():
    """No step of the plain loop builds an (S, Sk) score matrix: at S = 256
    in chunks of 32, the largest float32 tensor it allocates is one
    kv-chunk's scores for every q-chunk, (B, S, H, ck), eight times smaller
    than (B, H, S, S)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    sizes = []

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    sizes.append(t.numel())
            return out

    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(256, 256, H, "float32"))
    with Sizes():
        tattn.chunked_attention(q, k, v, causal=False, q_chunk=32, num_kv_heads=H)
    assert max(sizes) == 2 * 256 * H * 32


def test_mismatched_kv_heads_raise():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(32, 32, H, "float32"))
    with pytest.raises(ValueError, match="num_kv_heads"):
        tattn.chunked_attention(q, k, v, causal=True, q_chunk=32, num_kv_heads=H // 2)


@pytest.mark.parametrize("arch, seq, overrides", [
    ("qwen1.5-0.5b", 128, {}),
    ("whisper-medium", 128, {"num_frames": 96}),
], ids=["qwen", "whisper"])
def test_models_over_several_chunks_equal_reference(arch, seq, overrides):
    """A smoke model at ``attn_q_chunk=32`` whose attention spans several
    chunks (qwen: 4 causal q-chunks; whisper: 4 decoder chunks, 3 encoder
    chunks of 32 frames, cross-attention 4 x 3): logits, loss and every
    gradient leaf against the reference's."""
    jm, jp, pm = pair(arch, **overrides)
    assert pm.cfg.attn_q_chunk == 32
    check_forward_and_grads(jm, jp, pm, make_batch(pm.cfg, 2, seq, seed=3))


@pytest.mark.parametrize("s,cq", [(64, 64), (128, 32)], ids=["one_block", "chunks"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_plain_version_scale_none_keeps_its_bits(s, cq, dtype):
    """``scale=None`` is the 1/sqrt(head_dim) every existing caller had:
    output and q/k/v gradients bit for bit against that scale passed by
    hand (as a Python float and as its float32), in both branches of the
    plain version; Zamba2's (head_dim / 2)^-0.5 gives another output."""
    gen = torch.Generator().manual_seed(4)
    q, k, v, dout = (torch.randn((2, s, H, 32), generator=gen).to(dtype) for _ in range(4))

    def run(**kw):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = kattn.chunked_attention_ref(*leaves, causal=True, cq=cq, ck=cq, **kw)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, dout))

    default = run()
    for given in (32 ** -0.5, float(torch.tensor(32 ** -0.5, dtype=torch.float32))):
        for a, b in zip(default, run(scale=given)):
            assert torch.equal(a, b)
    assert not torch.equal(default[0], run(scale=16 ** -0.5)[0])
