"""Hopper kernel S1: Mamba2's chunked SSD scan (``ssd_chunked``), forward
and backward.

The reference's ``repro.models.mamba2.ssd_chunked`` is plain ``jnp`` (no
Pallas kernel): the quadratic term within a chunk, the chunk-final states,
the recurrence over chunks and the inter-chunk term, as einsums over
(B, chunks, H, Q, Q) float32 tensors. Its port here has two versions:

  ssd_chunked_ref  : the plain version, the reference's einsums in torch
                     (float32, or float64 for float64 inputs).
                     ``ssd_backward_ref`` writes out the backward's algebra
                     that the kernels implement (the tests hold it to
                     autograd of ``ssd_chunked_ref``), and
                     ``ssd_float64_ref`` gives what a check holds the
                     kernels to.
  SSDChunked       : the CUDA kernels of ``csrc/ssd_chunked.cu`` as an
                     autograd Function. The forward saves the chunk-entering
                     states (B, nc, H, P, N) float32; the backward recomputes
                     every Q x Q tile from x, dt, B and C.

What bounds it: at Zamba2-7B's shapes (B 4, S 4,096, H 112, P 64, N 64, G
2, Q 256) a forward needs about 60.8 GFLOP (0.06 ms at the bf16 peak) and
reads and writes about 0.49 GB (0.15 ms at 3.35 TB/s), so it is bound by
bytes; the eager chain moved about 19 GB a forward through (B, nc, H, Q,
Q) float32 intermediates. The kernels keep every Q x Q tile in shared
memory and registers: nothing of size Q x Q reaches device memory, C B^T
is computed once per (batch row, chunk, group, head block) and shared by
the block's heads (``heads_per_cta``). The arithmetic is float32 FMA on
the CUDA cores (the products' float32 operands keep full precision; the
tensor cores' float32 path is TF32), so the kernels are bound by the CUDA
cores' 67 TFLOP/s in practice, not by bytes. Off-diagonal 64 x 64 tiles
of the decay mask factor into two vectors (``exp(cs[q] - cs[r]) *
exp(cs[r] - cs[k])`` about a row ``r`` between them, both exponents <= 0)
that scale the products' rows, so only the diagonal tiles take an exp an
element. The within-chunk cumulative sums of ``dt * A`` are taken in
float64 (Q values a head), so the decay exponents lose nothing to
cancellation; every other intermediate is float32.

Shapes: x (B, S, H, P) and bmat, cmat (B, S, G, N) in float32 or
bfloat16 (one dtype), their last two dims packed (a view of a wider row,
as the block's projection split hands them, is read in place); dt (B, S,
H) float32; a (H,) and d_skip (H,) float32 or bfloat16 (a model whose
leaves are all bfloat16), taken in float32 as the plain version's type
promotion takes them, their gradients returned in their own dtype. The kernels take P <= 64, N <= 128
and chunks up to 256 (``chunk_len``: a chunk length that is not a
multiple of 64 is masked); other shapes raise ``ValueError``.

``ssd_forward.launches`` and ``ssd_backward.launches`` count the wrapper's
launches. ``models/mamba2.py::ssd_chunked`` dispatches: the kernels for
CUDA tensors (or a raise), the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fpisa_fused import raise_on

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/ssd_chunked.cu's dtype
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 128
MAX_HEADS_PER_CTA = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_L = ctypes.c_longlong


def chunk_len(s: int, chunk: int) -> int:
    """``min(chunk, s)``, halved until it divides ``s``."""
    q = min(chunk, s)
    while s % q:
        q //= 2
    return q


def _segsum(da: torch.Tensor) -> torch.Tensor:
    """da: (..., Q) -> (..., Q, Q), out[q, k] = sum_{i=k+1..q} da_i for
    q >= k, -inf above the diagonal."""
    css = torch.cumsum(da, dim=-1)
    diff = css[..., :, None] - css[..., None, :]
    q = da.shape[-1]
    mask = torch.ones((q, q), dtype=torch.bool, device=da.device).tril()
    return torch.where(mask, diff, -math.inf)


def _compute_dtype(dt: torch.Tensor) -> torch.dtype:
    """float32, the reference's; float64 when dt is (a check's exact run)."""
    return torch.float64 if dt.dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def ssd_chunked_ref(x, dt, a, bmat, cmat, d_skip, chunk: int):
    """SSD forward, the reference's einsums.

    x: (B, S, H, P); dt: (B, S, H) float32 (> 0, after softplus); a: (H,)
    float32 (< 0); bmat/cmat: (B, S, G, N); d_skip: (H,). Returns y (B, S,
    H, P) in x's dtype and the final state (B, H, P, N) float32 (float64
    when dt is)."""
    bsz, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hg = h // g
    q = chunk_len(s, chunk)
    nc = s // q
    f32 = _compute_dtype(dt)

    xf = x.to(f32)
    da = dt * a                       # (B, S, H), <= 0
    xb = xf * dt[..., None]           # dt-weighted input

    dac = da.reshape(bsz, nc, q, h)
    xbc = xb.reshape(bsz, nc, q, h, p)
    bc = bmat.reshape(bsz, nc, q, g, n).to(f32)
    cc = cmat.reshape(bsz, nc, q, g, n).to(f32)

    # intra-chunk (quadratic within a chunk)
    lmat = torch.exp(_segsum(dac.transpose(2, 3)))                  # (B, nc, H, Q, Q)
    scores = torch.einsum("bnqgs,bnkgs->bngqk", cc, bc)             # (B, nc, G, Q, Q)
    scores = scores.repeat_interleave(hg, dim=2)                    # (B, nc, H, Q, Q)
    y_diag = torch.einsum("bnhqk,bnkhp->bnqhp", lmat * scores, xbc)

    # chunk-final states
    css = torch.cumsum(dac, dim=2)                                  # (B, nc, Q, H)
    decay_to_end = torch.exp(css[:, :, -1:, :] - css)
    bfull = bc.repeat_interleave(hg, dim=3)                         # (B, nc, Q, H, N)
    states = torch.einsum("bnqhs,bnqh,bnqhp->bnhps", bfull, decay_to_end, xbc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(css[:, :, -1, :])                       # (B, nc, H)
    carry = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)                         # (B, nc, H, P, N)

    # inter-chunk contribution
    in_decay = torch.exp(css)
    cfull = cc.repeat_interleave(hg, dim=3)
    y_off = torch.einsum("bnqhs,bnqh,bnhps->bnqhp", cfull, in_decay, entering)

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    y = y + xf * d_skip[None, None, :, None]
    return y.to(x.dtype), carry


def ssd_backward_ref(x, dt, a, bmat, cmat, d_skip, chunk: int, dy, dfinal=None):
    """The backward of ``ssd_chunked_ref`` as the kernels compute it, in
    plain torch: -> (dx, ddt, da, dbmat, dcmat, dd_skip), each in its
    input's dtype. ``dy`` is y's gradient, ``dfinal`` the final state's
    (None: zero).

    Per chunk, with cs the within-chunk cumulative sum of dt * a, L[q, k] =
    exp(cs[q] - cs[k]) (q >= k), S = C B^T, M = L * S and xd = x * dt:
      y_off = exp(cs) * (C E^T)          W = dy E, dC += exp(cs) W,
                                         dE = (exp(cs) C)^T dy, dcs += exp(cs) rowsum(C W)
      reverse scan over chunks           G_c = dcarry_{c+1}, dcarry_c = dE_c + cd_c G_c,
                                         dcs[-1] += cd_c <G_c, E_c>
      states = (de B)^T xd               U = B G^T, dxd += de U, dB += de (xd G),
                                         dcs -= de rowsum(xd U), dcs[-1] += sum(de rowsum(xd U))
      y_diag = M xd                      dM = dy xd^T, dS = dM * L, dxd += M^T dy,
                                         dC += dS B, dB += dS^T C, T = dS * S (off the diagonal),
                                         dcs += rowsum(T) - colsum(T)
    with de = exp(cs[-1] - cs) and cd = exp(cs[-1]); then dda is the reverse
    cumulative sum of dcs, ddt = dda a + rowsum(dxd x), da = sum(dda dt),
    dx = dxd dt + dy d_skip, dd_skip = sum(dy x)."""
    bsz, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hg = h // g
    q = chunk_len(s, chunk)
    nc = s // q
    ct = _compute_dtype(dt)

    xf = x.to(ct).reshape(bsz, nc, q, h, p)
    dtc = dt.to(ct).reshape(bsz, nc, q, h)
    dyc = dy.to(ct).reshape(bsz, nc, q, h, p)
    bc = bmat.to(ct).reshape(bsz, nc, q, g, n).repeat_interleave(hg, dim=3)   # (B, nc, Q, H, N)
    cc = cmat.to(ct).reshape(bsz, nc, q, g, n).repeat_interleave(hg, dim=3)
    xd = xf * dtc[..., None]
    cs = torch.cumsum(dtc * a.to(ct), dim=2)                                 # (B, nc, Q, H)
    keep = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[..., None]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]                        # (B, nc, Q, Q, H)
    lmat = torch.where(keep, torch.exp(torch.where(keep, seg, 0.0)), 0.0)
    smat = torch.einsum("bcqhn,bckhn->bcqkh", cc, bc)
    de = torch.exp(cs[:, :, -1:] - cs)
    din = torch.exp(cs)
    cd = torch.exp(cs[:, :, -1])                                             # (B, nc, H)

    # the forward's entering states
    st = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", bc, de, xd)
    ent, carry = [], torch.zeros((bsz, h, p, n), dtype=ct, device=x.device)
    for c in range(nc):
        ent.append(carry)
        carry = carry * cd[:, c, :, None, None] + st[:, c]
    ent = torch.stack(ent, dim=1)                                            # (B, nc, H, P, N)

    # the inter-chunk term
    w = torch.einsum("bcqhp,bchpn->bcqhn", dyc, ent)
    dc = din[..., None] * w
    dcs = din * (cc * w).sum(-1)
    de_ent = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", din, cc, dyc)

    # the reverse scan over chunks
    gr = (torch.zeros((bsz, h, p, n), dtype=ct, device=x.device) if dfinal is None
          else dfinal.to(ct))
    gs, dcd = [None] * nc, torch.zeros((bsz, nc, h), dtype=ct, device=x.device)
    for c in reversed(range(nc)):
        gs[c] = gr
        dcd[:, c] = (gr * ent[:, c]).sum((-2, -1))
        gr = de_ent[:, c] + gr * cd[:, c, :, None, None]
    gst = torch.stack(gs, dim=1)
    dcs[:, :, -1] += dcd * cd

    # the chunk-final states
    u = torch.einsum("bcqhn,bchpn->bcqhp", bc, gst)
    dxd = de[..., None] * u
    db = de[..., None] * torch.einsum("bcqhp,bchpn->bcqhn", xd, gst)
    tst = de * (xd * u).sum(-1)
    dcs = dcs - tst
    dcs[:, :, -1] += tst.sum(2)

    # the quadratic term within a chunk
    dm = torch.einsum("bcqhp,bckhp->bcqkh", dyc, xd)
    ds = dm * lmat
    dxd = dxd + torch.einsum("bcqkh,bcqhp->bckhp", lmat * smat, dyc)
    dc = dc + torch.einsum("bcqkh,bckhn->bcqhn", ds, bc)
    db = db + torch.einsum("bcqkh,bcqhn->bckhn", ds, cc)
    tmat = ds * smat * (1 - torch.eye(q, dtype=ct, device=x.device))[..., None]
    dcs = dcs + tmat.sum(3) - tmat.sum(2)

    dda = dcs.flip(2).cumsum(2).flip(2)
    ddt = dda * a.to(ct) + (dxd * xf).sum(-1)
    da = (dda * dtc).sum((0, 1, 2))
    dd = (dyc * xf).sum((0, 1, 2, 4))
    dx = dxd * dtc[..., None] + dyc * d_skip.to(ct)[:, None]
    db = db.reshape(bsz, nc, q, g, hg, n).sum(4).reshape(bsz, s, g, n)
    dc = dc.reshape(bsz, nc, q, g, hg, n).sum(4).reshape(bsz, s, g, n)
    return (dx.reshape(bsz, s, h, p).to(x.dtype), ddt.reshape(bsz, s, h).to(dt.dtype),
            da.to(a.dtype), db.to(bmat.dtype), dc.to(cmat.dtype), dd.to(d_skip.dtype))


def ssd_float64_ref(x, dt, a, bmat, cmat, d_skip, chunk: int, dy, dfinal=None):
    """What a check holds S1 to: ``ssd_chunked_ref`` in float64 on the same
    values, and autograd of sum(y dy) + sum(final dfinal) through it, a
    batch row at a time (its (1, nc, H, Q, Q) float64 intermediates are what
    bound the memory) -> (y, final, (dx, ddt, da, dbmat, dcmat, dd_skip)),
    all float64."""
    a64, d64 = a.double().requires_grad_(), d_skip.double().requires_grad_()
    ys, fins, grads = [], [], []
    for r in range(x.shape[0]):
        row = [t[r:r + 1].double().requires_grad_() for t in (x, dt, bmat, cmat)]
        y, fin = ssd_chunked_ref(row[0], row[1], a64, row[2], row[3], d64, chunk)
        loss = (y * dy[r:r + 1].double()).sum()
        if dfinal is not None:
            loss = loss + (fin * dfinal[r:r + 1].double()).sum()
        grads.append(torch.autograd.grad(loss, row + [a64, d64]))
        ys.append(y.detach())
        fins.append(fin.detach())
    cat = [torch.cat([g[k] for g in grads]) for k in range(4)]
    return (torch.cat(ys), torch.cat(fins),
            (cat[0], cat[1], sum(g[4] for g in grads), cat[2], cat[3],
             sum(g[5] for g in grads)))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_chunked")
    lib.ssd_chunked_fwd.argtypes = [_I, _P, _L, _L, _P, _P, _P, _L, _L, _P, _L, _L, _P,
                                    _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.ssd_chunked_fwd.restype = _I
    lib.ssd_chunked_bwd.argtypes = [_I, _P, _L, _L, _P, _P, _P, _L, _L, _P, _L, _L, _P,
                                    _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.ssd_chunked_bwd.restype = _I
    lib.ssd_chunked_workspace.argtypes = [_I, _I, _I, _I, _I, _I, _I, _I]
    lib.ssd_chunked_workspace.restype = _L
    lib.ssd_chunked_kernel_info.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.ssd_chunked_kernel_info.restype = _I
    return lib


# in csrc/ssd_chunked.cu's ssd_chunked_kernel_info order (bfloat16 instantiations)
KERNELS = ("ssd_state_fwd_kernel", "ssd_fwd_kernel", "ssd_state_bwd_kernel", "ssd_bwd_kernel",
           "ssd_dbc_kernel", "ssd_ddt_kernel", "ssd_reduce_kernel")


def kernel_info(n: int = 64, q: int = 256) -> dict:
    """{kernel: {"registers", "ctas_per_sm", "smem_bytes", "threads",
    "local_bytes"}} of each bfloat16 kernel on the current CUDA device, with
    the shared memory it takes at state size ``n`` and chunk ``q``
    (``local_bytes``, a thread's local memory, is what ptxas spilled)."""
    info = {}
    for which, name in enumerate(KERNELS):
        out = (_I * 5)()
        raise_on(_lib().ssd_chunked_kernel_info(which, n, q, out), "ssd_chunked_kernel_info")
        info[name] = dict(zip(("registers", "ctas_per_sm", "smem_bytes", "threads",
                               "local_bytes"), out))
    return info


def heads_per_cta(hg: int) -> int:
    """The heads of one B/C group that a CTA walks in turn, sharing its C
    B^T tiles: the largest divisor of the group's ``hg`` heads up to 8."""
    return max(d for d in range(1, min(hg, MAX_HEADS_PER_CTA) + 1) if hg % d == 0)


def _packed(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its last two dims are packed (read in place with its batch
    and sequence strides), else a contiguous copy."""
    return t if t.stride(-1) == 1 and t.stride(-2) == t.shape[-1] else t.contiguous()


def check_inputs(x, dt, a, bmat, cmat, d_skip, chunk: int) -> int:
    """What the kernels take (see the module docstring); returns the chunk
    length."""
    for name, t in (("x", x), ("dt", dt), ("a", a), ("bmat", bmat), ("cmat", cmat),
                    ("d_skip", d_skip)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x must be one of {tuple(DTYPE_CODES)}, got {x.dtype}")
    if bmat.dtype != x.dtype or cmat.dtype != x.dtype:
        raise ValueError(f"bmat and cmat must be {x.dtype} like x, got {bmat.dtype}, "
                         f"{cmat.dtype}")
    if dt.dtype != torch.float32:
        raise ValueError(f"dt must be float32, got {dt.dtype}")
    for name, t in (("a", a), ("d_skip", d_skip)):
        if t.dtype not in DTYPE_CODES:
            raise ValueError(f"{name} must be one of {tuple(DTYPE_CODES)}, got {t.dtype}")
    if x.dim() != 4 or bmat.dim() != 4:
        raise ValueError(f"x and bmat must be 4-d, got {tuple(x.shape)}, {tuple(bmat.shape)}")
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if bmat.shape[:2] != (b, s) or cmat.shape != bmat.shape:
        raise ValueError(f"bmat and cmat must be (B, S, G, N) beside x {tuple(x.shape)}, "
                         f"got {tuple(bmat.shape)}, {tuple(cmat.shape)}")
    if dt.shape != (b, s, h) or a.shape != (h,) or d_skip.shape != (h,):
        raise ValueError(f"dt must be (B, S, H) and a, d_skip (H,), got {tuple(dt.shape)}, "
                         f"{tuple(a.shape)}, {tuple(d_skip.shape)}")
    if h % g:
        raise ValueError(f"heads ({h}) must be a multiple of groups ({g})")
    if p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"the kernels take head_dim <= {MAX_HEAD_DIM} and state <= "
                         f"{MAX_STATE}, got {p} and {n}")
    if s < 1 or chunk < 1:
        raise ValueError(f"sequence and chunk must be positive, got {s} and {chunk}")
    q = chunk_len(s, chunk)
    if q > MAX_CHUNK:
        raise ValueError(f"the kernels take chunks of at most {MAX_CHUNK}, got {q}")
    return q


def _strides(t: torch.Tensor) -> tuple[int, int]:
    return t.stride(0), t.stride(1)


def ssd_forward(x, dt, a, bmat, cmat, d_skip, chunk: int):
    """Launch the forward: -> (y like x, final state (B, H, P, N) float32,
    entering states (B, nc, H, P, N) float32)."""
    q = check_inputs(x, dt, a, bmat, cmat, d_skip, chunk)
    x, bmat, cmat = _packed(x), _packed(bmat), _packed(cmat)
    dt, a, d_skip = dt.contiguous(), a.float().contiguous(), d_skip.float().contiguous()
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    states = torch.empty((b, s // q, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    raise_on(_lib().ssd_chunked_fwd(
        DTYPE_CODES[x.dtype], x.data_ptr(), *_strides(x), dt.data_ptr(), a.data_ptr(),
        bmat.data_ptr(), *_strides(bmat), cmat.data_ptr(), *_strides(cmat), d_skip.data_ptr(),
        y.data_ptr(), final.data_ptr(), states.data_ptr(), b, s, h, p, g, n, q,
        heads_per_cta(h // g), stream), "ssd_chunked_fwd")
    ssd_forward.launches += 1
    return y, final, states


def ssd_backward(x, dt, a, bmat, cmat, d_skip, chunk: int, states, dy, dfinal=None):
    """Launch the backward: -> (dx like x, ddt, da, dbmat, dcmat, dd_skip)."""
    q = check_inputs(x, dt, a, bmat, cmat, d_skip, chunk)
    x, bmat, cmat, dy = _packed(x), _packed(bmat), _packed(cmat), _packed(dy)
    a_dtype, d_dtype = a.dtype, d_skip.dtype
    dt, a, d_skip = dt.contiguous(), a.float().contiguous(), d_skip.float().contiguous()
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {x.dtype}{tuple(x.shape)} on {x.device}, got "
                         f"{dy.dtype}{tuple(dy.shape)} on {dy.device}")
    if states.shape != (b, s // q, h, p, n) or states.dtype != torch.float32:
        raise ValueError(f"states must be float32{(b, s // q, h, p, n)}, got "
                         f"{states.dtype}{tuple(states.shape)}")
    if dfinal is not None:
        if dfinal.shape != (b, h, p, n) or dfinal.dtype != torch.float32:
            raise ValueError(f"dfinal must be float32{(b, h, p, n)}, got "
                             f"{dfinal.dtype}{tuple(dfinal.shape)}")
        dfinal = dfinal.contiguous()
    hb = heads_per_cta(h // g)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
    da = torch.empty((h,), dtype=torch.float32, device=x.device)
    dd = torch.empty((h,), dtype=torch.float32, device=x.device)
    db = torch.empty((b, s, g, n), dtype=x.dtype, device=x.device)
    dc = torch.empty_like(db)
    work = torch.empty(_lib().ssd_chunked_workspace(b, s, h, p, g, n, q, hb),
                       dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    raise_on(_lib().ssd_chunked_bwd(
        DTYPE_CODES[x.dtype], x.data_ptr(), *_strides(x), dt.data_ptr(), a.data_ptr(),
        bmat.data_ptr(), *_strides(bmat), cmat.data_ptr(), *_strides(cmat), d_skip.data_ptr(),
        dy.data_ptr(), *_strides(dy), 0 if dfinal is None else dfinal.data_ptr(),
        states.contiguous().data_ptr(), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
        db.data_ptr(), dc.data_ptr(), dd.data_ptr(), work.data_ptr(),
        b, s, h, p, g, n, q, hb, stream), "ssd_chunked_bwd")
    ssd_backward.launches += 1
    return dx, ddt, da.to(a_dtype), db, dc, dd.to(d_dtype)


ssd_forward.launches = 0
ssd_backward.launches = 0


class SSDChunked(torch.autograd.Function):
    """S1's forward and its recomputing backward: apply(x, dt, a, bmat,
    cmat, d_skip, chunk) -> (y, final state)."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, d_skip, chunk: int):
        y, final, states = ssd_forward(x, dt, a, bmat, cmat, d_skip, chunk)
        ctx.save_for_backward(x, dt, a, bmat, cmat, d_skip, states)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, bmat, cmat, d_skip, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_backward(x, dt, a, bmat, cmat, d_skip, ctx.chunk, states, dy, dfinal)
        return (*grads, None)
