"""Hopper kernel A1: the reference's chunked (online-softmax) attention.

The reference's ``repro.models.attention.chunked_attention`` is plain
``jnp`` (no Pallas kernel): it scans (q-chunk, kv-chunk) pairs through an
online softmax. Its port here has two versions of the same function:

  chunked_attention_ref : the plain version, the reference's loop in torch.
                          It walks the kv-chunks ``j`` in ascending order
                          and updates every q-chunk that pairs with ``j``
                          (all of them; when causal, ``i >= j``) in one
                          batched step, so each q-chunk's state sees
                          ``j = 0, 1, ...`` in turn, as the scan feeds it.
                          The one-block case (``nq == nk == 1``) is one
                          masked float32 softmax, as in the reference.
  ChunkedAttention      : the CUDA kernels of ``csrc/chunked_attention.cu``
                          as an autograd Function: ``attention_forward``
                          (the chunks in the reference's order, one pass
                          over 64-key tiles) saves q, k, v, the output and
                          each row's final max ``m`` and sum ``l``;
                          ``attention_backward`` recomputes the score tiles
                          from them (dQ, then dK/dV), as ``flash_remat``
                          recomputes the pair step, and saves nothing of
                          size (S, Sk).

The kernels take one of two routes, by dtype (each dtype has one; a
failure raises):

  bfloat16 : the tensor cores. Every product is a ``wgmma`` and every
             operand tile arrives by TMA. The forward runs one CTA per
             (batch row, head, 128 query rows): two consumer warpgroups of
             64 rows and a producer warp that streams 64-key K/V tiles
             through a ring. The backward's two kernels have no producer
             warp (256 threads, so ptxas may give a thread 255 registers):
             the warpgroup that frees a ring stage second refills it. dQ
             runs one CTA per 128 query rows (two CTAs an SM at head_dim
             64), dK/dV one per 128 keys, 64 keys a warpgroup with K/V
             resident and each streamed query tile (q, dO, the rows' m,
             1/l and D) feeding both. Each backward warpgroup issues a
             tile's two score products (S and dP, or S^T and dP^T) as
             separate groups and waits only for the one it needs, so P is
             computed while dP is in flight, and in dK/dV dS^T while dV's
             product is; the causal mask is applied only on the diagonal
             tile (and dQ's ragged last one). Bound by the flops at 989
             TFLOP/s; the two backward kernels compute 7 hd-products a
             kept pair against the bound's 5 (S and dP in both), so their
             best case is about 71 % of the backward's bound. P and dS are
             rounded to bf16 where they are operands of a product, as the
             plain loop's autograd rounds them. TMA needs 16-byte aligned
             tensors and head_dim a multiple of 8; the wrapper checks both
             and raises. Head dims past 128 (Zamba2's 224) take the
             "wide" kernels (``attn_*_tc_wide``): the head dims padded to
             256, and both warpgroups of a CTA on the same 64 query rows
             (forward, dQ) or keys (dK/dV), each computing the score
             products whole and owning the output's head dims 0-127 or
             128-223 (a warpgroup cannot hold two 64 x 224 float32
             accumulators, o and the chunk's p.v, or dK and dV); no
             producer warp in any of the three.
  float32  : the CUDA cores (FMA over float32 tiles in shared memory): the
             tensor cores' float32 path is TF32, which would break the
             float32 tolerance the checks hold A1 to, and float32 A1 runs
             only in checks. Past 128 head dims the backward sums the
             score products over 64-dim slices (``attn_bwd_*_wide``).

``attention_forward.routes`` and ``attention_backward.routes`` count the
launches of each route (``"wgmma"``, ``"cuda_cores"``) beside
``.launches``. ``kernel_info()`` reads each bf16 kernel's registers,
resident CTAs per SM and spilled bytes on the current card.

``kernels/ops.py::chunked_attention`` dispatches: the kernel for CUDA
tensors (or a raise), the plain version for CPU tensors. The plain version
runs on a CUDA tensor only when a caller asks for it by name, as the tests
and ``chip_smoke.py`` do to hold the kernel to it.

Shapes: q (B, S, H, hd); k, v (B, Sk, K, hd) with H a multiple of K (GQA:
query head h reads kv head h // (H / K)); causal needs S == Sk. The plain
version takes grouped K/V; the kernel takes K == H (``ops`` repeats a
grouped call's K/V first), float32 and bfloat16, hd <= 256. ``scale``
multiplies the scores (None: 1/sqrt(hd), the reference's; Zamba2's
attention takes (hd / 2)^-0.5).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import _build
from repro_torch.kernels.fpisa_fused import raise_on

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/chunked_attention.cu's dtype
ROUTES = {torch.float32: "cuda_cores", torch.bfloat16: "wgmma"}
MAX_HEAD_DIM = 256
TMA_ALIGN = 16  # bytes: TMA's base address and row stride

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def chunk_sizes(s: int, sk: int, q_chunk: int) -> tuple[int, int]:
    """The reference's (cq, ck): ``min(q_chunk, length)``, halved until it
    divides the length."""
    cq, ck = min(q_chunk, s), min(q_chunk, sk)
    while s % cq:
        cq //= 2
    while sk % ck:
        ck //= 2
    return cq, ck


def _scale(hd: int, scale: float | None = None) -> float:
    """The scores' scale as float32 (what a float32 tensor times the Python
    float is): ``scale``, or 1/sqrt(hd) when it is None."""
    return float(torch.tensor(1.0 / math.sqrt(hd) if scale is None else scale,
                              dtype=torch.float32))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _pair_step(o, m, l, qi, kj, vj, keep, scale: float):
    """One kv-chunk against a batch of q-chunks. qi (b, n, cq, K, g, hd);
    kj, vj (b, ck, K, hd); state o (b, n, cq, K, g, hd), m and l (b, n, cq,
    K, g), float32; keep (n, cq, 1, 1, ck) bool or None."""
    scores = torch.einsum("bnqkgh,bckh->bnqkgc", qi, kj).to(torch.float32) * scale
    if keep is not None:
        scores = torch.where(keep, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum(
        "bnqkgc,bckh->bnqkgh", p.to(vj.dtype), vj).to(torch.float32)
    return o_new, m_new, l_new


def chunked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                          cq: int, ck: int, remat_step: bool = True,
                          scale: float | None = None) -> torch.Tensor:
    """The plain version (see the module docstring). ``remat_step`` wraps
    each batched step in ``torch.utils.checkpoint``, as the reference wraps
    its pair step in ``jax.checkpoint``. ``scale`` multiplies the scores
    (None: 1/sqrt(head_dim))."""
    b, s, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = _scale(hd, scale)
    nq, nk = s // cq, sk // ck
    if nq == 1 and nk == 1:
        qf = q.reshape(b, s, kvh, g, hd)
        scores = torch.einsum("bqkgh,bckh->bkgqc", qf, k).to(torch.float32) * scale
        if causal:
            keep = torch.ones((s, sk), dtype=torch.bool, device=q.device).tril()
            scores = torch.where(keep, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqc,bckh->bqkgh", w.to(v.dtype), v)
        return out.reshape(b, s, h, hd)
    if causal and nq != nk:
        raise ValueError(f"causal attention needs S == Sk, got {s} and {sk}")
    qc = q.reshape(b, nq, cq, kvh, g, hd)
    kc = k.reshape(b, nk, ck, kvh, hd)
    vc = v.reshape(b, nk, ck, kvh, hd)
    rows = torch.arange(s, device=q.device).reshape(nq, cq)
    cols = torch.arange(sk, device=q.device).reshape(nk, ck)
    o = torch.zeros((b, nq, cq, kvh, g, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, nq, cq, kvh, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    step = functools.partial(checkpoint, _pair_step, use_reentrant=False) if remat_step \
        else _pair_step
    done = []  # causal: chunk j has had its last pair after step j
    for j in range(nk):
        lo = j if causal else 0
        keep = None
        if causal:
            keep = (rows[lo:, :, None] >= cols[j][None, None, :])[:, :, None, None, :]
        o, m, l = step(o, m, l, qc[:, lo:], kc[:, j], vc[:, j], keep, scale)
        if causal:
            done.append((o[:, :1], l[:, :1]))
            o, m, l = o[:, 1:], m[:, 1:], l[:, 1:]
    if causal:
        o = torch.cat([d[0] for d in done], dim=1)
        l = torch.cat([d[1] for d in done], dim=1)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, s, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("chunked_attention")
    lib.chunked_attention_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _I, _F, _P]
    lib.chunked_attention_fwd.restype = _I
    lib.chunked_attention_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _I, _F, _P]
    lib.chunked_attention_bwd.restype = _I
    lib.chunked_attention_kernel_info.argtypes = [_I, ctypes.POINTER(_I)]
    lib.chunked_attention_kernel_info.restype = _I
    return lib


# the bf16 kernels, in csrc/chunked_attention.cu's chunked_attention_kernel_info order
TC_KERNELS = ("attn_fwd_tc<1>", "attn_fwd_tc<2>", "attn_bwd_dq_tc<1>", "attn_bwd_dq_tc<2>",
              "attn_bwd_dkv_tc<1>", "attn_bwd_dkv_tc<2>", "attn_fwd_tc_wide",
              "attn_bwd_dq_tc_wide", "attn_bwd_dkv_tc_wide")


def kernel_info() -> dict:
    """{kernel: {"registers", "ctas_per_sm", "smem_bytes", "threads",
    "local_bytes"}} of each bf16 kernel on the current CUDA device
    (registers a thread at launch, the forward's warpgroups then moving
    registers with ``setmaxnreg``; ``local_bytes``, a thread's local memory,
    is what ptxas spilled)."""
    info = {}
    for which, name in enumerate(TC_KERNELS):
        out = (_I * 5)()
        raise_on(_lib().chunked_attention_kernel_info(which, out), "chunked_attention_kernel_info")
        info[name] = dict(zip(("registers", "ctas_per_sm", "smem_bytes", "threads",
                               "local_bytes"), out))
    return info


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    """What the kernels take: CUDA tensors of one dtype (float32 or
    bfloat16) on one device, q (B, S, H, hd), k and v (B, Sk, H, hd),
    hd <= 256 (bfloat16: a multiple of 8, TMA's 16-byte rows), S == Sk when
    causal."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got shape {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"q, k, v must share dtype and device, got {q.dtype} on "
                             f"{q.device} and {t.dtype} on {t.device} ({name})")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype must be one of {tuple(DTYPE_CODES)}, got {q.dtype}")
    b, s, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, hd):
        raise ValueError(f"k, v must be (B, Sk, H, hd) beside q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be at most {MAX_HEAD_DIM}, got {hd}")
    if q.dtype == torch.bfloat16 and (hd * q.element_size()) % TMA_ALIGN:
        raise ValueError(f"bfloat16 head_dim must be a multiple of {TMA_ALIGN // 2} (TMA moves "
                         f"rows of 16-byte multiples), got {hd}")
    if causal and k.shape[1] != s:
        raise ValueError(f"causal attention needs S == Sk, got {s} and {k.shape[1]}")


def check_aligned(*tensors: torch.Tensor) -> None:
    """TMA reads a bfloat16 tensor from a 16-byte aligned base: raise on a
    view that starts elsewhere (float32 takes any)."""
    for t in tensors:
        if t.dtype == torch.bfloat16 and t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"bfloat16 tensors must start on a {TMA_ALIGN}-byte boundary (TMA), "
                             f"got a {tuple(t.shape)} view at address {t.data_ptr():#x}")


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                      ck: int, scale: float | None = None):
    """Launch the forward kernel: -> (out like q, m, l (B, H, S) float32).
    ``scale`` multiplies the scores (None: 1/sqrt(head_dim))."""
    check_inputs(q, k, v, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, s, h, hd = q.shape
    sk = k.shape[1]
    if ck <= 0 or sk % ck:
        raise ValueError(f"ck must divide Sk = {sk}, got {ck}")
    check_aligned(q, k, v)
    out = torch.empty_like(q)
    m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    raise_on(_lib().chunked_attention_fwd(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), b, s, sk, h, hd, ck, int(causal), _scale(hd, scale), stream),
        "chunked_attention_fwd")
    attention_forward.launches += 1
    attention_forward.routes[ROUTES[q.dtype]] += 1
    return out, m, l


def attention_backward(q, k, v, out, dout, m, l, causal: bool, scale: float | None = None):
    """Launch the backward kernels (dQ, then dK/dV): -> (dq, dk, dv)."""
    check_inputs(q, k, v, causal)
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout must be {q.dtype}{tuple(q.shape)}, got "
                         f"{dout.dtype}{tuple(dout.shape)}")
    check_aligned(q, k, v, out, dout)
    b, s, h, hd = q.shape
    sk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # scratch: float32 keeps D (B, H, S) in it; bfloat16 each row's m, 1/l
    # and D, S padded to a multiple of 64 (TMA boxes on 256-byte boundaries)
    dbuf = torch.empty(b * h * 3 * (-(-s // 64) * 64), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    raise_on(_lib().chunked_attention_bwd(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), m.data_ptr(), l.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dbuf.data_ptr(), b, s, sk, h, hd, int(causal), _scale(hd, scale),
        stream),
        "chunked_attention_bwd")
    attention_backward.launches += 1
    attention_backward.routes[ROUTES[q.dtype]] += 1
    return dq, dk, dv


attention_forward.launches = 0
attention_backward.launches = 0
attention_forward.routes = dict.fromkeys(ROUTES.values(), 0)
attention_backward.routes = dict.fromkeys(ROUTES.values(), 0)


class ChunkedAttention(torch.autograd.Function):
    """A1 forward and its recomputing backward: apply(q, k, v, causal, ck,
    scale=None)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, ck: int, scale: float | None = None):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, m, l = attention_forward(q, k, v, causal, ck, scale)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, dout, m, l, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None
