"""GQA attention for training and serving, and the encoder-decoder's
cross-attention (torch port of ``repro.models.attention``).

Training, prefill and cross-attention go through ``chunked_attention``, the
reference's flash-style function with its signature: q-chunks of
``cfg.attn_q_chunk`` rows against kv-chunks of as many keys (each halved
until it divides its length), an online softmax over the kv-chunks in
ascending order (lower triangle of chunks when causal) with float32 state,
scores from the compute-dtype product upcast to float32 and scaled, the
mask at -1e30 by global position, the weights cast to V's dtype before the
product, and ``o / max(l, 1e-30)`` out; one chunk each way is one masked
float32 softmax, as in the reference. So scores are held one (cq, ck)
block at a time, the whole (S, Sk) only where that is one block. On the
card this is kernel A1 (``kernels/attention.py``,
``csrc/chunked_attention.cu``: the same steps over 64 x 64 tiles, and a
backward that recomputes them); on the CPU the reference's loop, each step
checkpointed when ``cfg.flash_remat`` is set, as the reference checkpoints
its pair step.

Cross-attention (``cross_attention``, ``encode_cross_kv``): q from the
decoder states alone, with no bias and no RoPE, over K/V projected once
from the encoder states; every frame is attended, in training, prefill and
decode alike (the reference calls the one function in all three).

Serving: ``attention_prefill`` (full-sequence attention that writes K/V at
[0, S) of a dense cache), ``attention_decode`` (one new token per row at a
shared position ``pos``) and ``attention_decode_paged`` (per-row positions
over a global page pool). The caches are written IN PLACE (``index_put_``;
the reference donates them to XLA), never copied whole. Decode keeps the
reference's grouped ``(b, kvh, g, hd)`` form and its dtype steps: scores
from the compute-dtype product, upcast to float32 and divided by
sqrt(head_dim), masked at -1e30, softmax in float32, weights cast back to
the cache dtype before the product with V.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.attention import NEG_INF, chunk_sizes
from repro_torch.models.layers import apply_rope, dtype_of, param, rope_angles
from repro_torch.sharding.hints import local_product


def init_attention(gen: torch.Generator, cfg, lead=()) -> dict:
    """Reference shapes: wq (d, h, hd), wk/wv (d, k, hd), wo (h, hd, d),
    biases (h|k, hd); sorted keys (the reference's flatten order)."""
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = dtype_of(cfg.param_dtype)
    p = {}
    if cfg.qkv_bias:
        p["bk"] = param(gen, (*lead, k, hd), dt, scale=0.0)
        p["bq"] = param(gen, (*lead, h, hd), dt, scale=0.0)
        p["bv"] = param(gen, (*lead, k, hd), dt, scale=0.0)
    p["wk"] = param(gen, (*lead, d, k, hd), dt)
    p["wo"] = param(gen, (*lead, h, hd, d), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers))
    p["wq"] = param(gen, (*lead, d, h, hd), dt)
    p["wv"] = param(gen, (*lead, d, k, hd), dt)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, hd = w.shape
    if hasattr(w, "device_mesh") and not _splits(w, 1):
        return _project_local(x, w)
    y = x @ w.reshape(d, h * hd)
    if hasattr(y, "device_mesh"):
        # heads split where the weight splits them, nowhere else
        from torch.distributed.tensor import Replicate, Shard

        y = y.redistribute(y.device_mesh, [
            Shard(2) if getattr(wp, "dim", None) == 1
            else (yp if getattr(yp, "dim", None) == 0 else Replicate())
            for wp, yp in zip(w.placements, y.placements)])
    return y.unflatten(-1, (h, hd))


def _splits(w, dim: int) -> bool:
    """Whether DTensor ``w`` splits dimension ``dim`` over the mesh."""
    return hasattr(w, "device_mesh") and any(
        getattr(p, "dim", None) == dim and w.device_mesh.size(i) > 1
        for i, p in enumerate(w.placements))


def _project_local(x, w):
    """``_project`` of a DTensor weight whose heads are whole: head_dim
    split (the 'hdim' mode) or not split at all (replicated K/V), on each
    rank's local tensors (``hints.local_product``): merging (h, hd) with hd
    split would make a strided shard, and DTensor may split the merged
    columns across a head."""
    from torch.distributed.tensor import DTensor, Shard

    d, h, hd = w.shape
    y = local_product(x, w, 2)
    local = y.to_local()
    pls = [Shard(3) if getattr(p, "dim", None) == y.ndim - 1 else p for p in y.placements]
    return DTensor.from_local(local.unflatten(-1, (h, local.shape[-1] // h)), y.device_mesh,
                              pls, run_check=False)


def _qkv(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor | None = None,
         angles=None):
    """q, k, v with RoPE at ``positions``, or at precomputed ``angles``
    (``rope_angles`` of them, shared by every layer of one step)."""
    q, k, v = _project(x, p["wq"]), _project(x, p["wk"]), _project(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if angles is None and positions is not None:
        angles = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    if angles is not None:
        cos, sin = angles
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k, v


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, cfg):
    """Materialize GQA KV to the full head count (as the reference does for
    training)."""
    g = cfg.num_heads // cfg.num_kv_heads
    if g == 1:
        return k, v
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                      q_chunk: int, num_kv_heads: int, remat_step: bool = True,
                      scale: float | None = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, Sk, K, hd) with K = ``num_kv_heads``
    -> (B, S, H, hd) in q's dtype. ``causal`` needs S == Sk. ``scale``
    multiplies the scores (None: 1/sqrt(hd), the reference's).

    DTensors (a step on a mesh): the heads and the batch rows attend
    independently, so every rank attends with its own rows and heads, on
    its local tensors, and the result keeps those placements; a sequence
    or head_dim split is gathered first. DTensor's own products would merge
    the batch and a sharded head axis into one strided-sharded axis."""
    if k.shape[2] != num_kv_heads:
        raise ValueError(f"k has {k.shape[2]} heads, num_kv_heads={num_kv_heads}")
    cq, ck = chunk_sizes(q.shape[1], k.shape[1], q_chunk)
    if hasattr(q, "device_mesh"):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = q.device_mesh
        pl = [p if getattr(p, "dim", None) in (0, 2) else Replicate() for p in q.placements]
        q, k, v = (t.redistribute(mesh, pl).to_local() for t in (q, k, v))
        out = ops.chunked_attention(q, k, v, causal=causal, cq=cq, ck=ck, remat_step=remat_step,
                                    scale=scale)
        return DTensor.from_local(out, mesh, pl, run_check=False)
    return ops.chunked_attention(q, k, v, causal=causal, cq=cq, ck=ck, remat_step=remat_step,
                                 scale=scale)


def _attend(q, k, v, cfg, causal: bool) -> torch.Tensor:
    """``chunked_attention`` as the reference's call sites call it: K/V
    already repeated to every head, the config's chunk and remat."""
    return chunked_attention(q, k, v, causal=causal, q_chunk=cfg.attn_q_chunk,
                             num_kv_heads=cfg.num_heads, remat_step=cfg.flash_remat)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, hd, d = wo.shape
    if _splits(wo, 1):  # 'hdim' mode: each rank's columns (see _project_local)
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh = wo.device_mesh
        wo = wo.redistribute(mesh, [p if getattr(p, "dim", None) == 1 else Replicate()
                                    for p in wo.placements])
        split = [getattr(p, "dim", None) == 1 for p in wo.placements]
        out = out.redistribute(mesh, [Shard(3) if sp else (p if getattr(p, "dim", None) == 0
                                                           else Replicate())
                                      for sp, p in zip(split, out.placements)])
        rows = [getattr(p, "dim", None) == 0 for p in out.placements]
        wl = wo.to_local(grad_placements=[Partial() if r else p
                                          for r, p in zip(rows, wo.placements)])
        y = out.to_local().flatten(-2) @ wl.reshape(-1, d)
        return DTensor.from_local(y, mesh, [Partial() if sp else p
                                            for sp, p in zip(split, out.placements)],
                                  run_check=False)
    return out.flatten(-2) @ wo.reshape(h * hd, d)


def attention_train(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                    causal: bool = True, rope: bool = True) -> torch.Tensor:
    """Self-attention over the whole sequence; the encoder calls it with
    ``causal=False`` and keeps RoPE over the frame positions, as the
    reference does."""
    q, k, v = _qkv(p, x, cfg, positions if rope else None)
    k, v = _repeat_kv(k, v, cfg)
    return _out_proj(_attend(q, k, v, cfg, causal), p["wo"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Smax, K, hd)
    v: torch.Tensor


def init_kv_cache(batch: int, max_len: int, cfg, dtype, device) -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def attention_prefill(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                      cache: KVCache):
    """Full-sequence causal attention; k/v are written into the cache at
    [0, S), in place. Returns (out (B, S, d), cache)."""
    q, k, v = _qkv(p, x, cfg, positions)
    s = x.shape[1]
    cache.k[:, :s] = k.to(cache.k.dtype)
    cache.v[:, :s] = v.to(cache.v.dtype)
    k, v = _repeat_kv(k, v, cfg)
    return _out_proj(_attend(q, k, v, cfg, True), p["wo"]), cache


def _attend_one(p: dict, q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                valid: torch.Tensor, cfg) -> torch.Tensor:
    """One query token per row over a cache view: q (B, 1, H, hd); keys,
    values (B, S, K, hd); valid bool (B or 1, S). Returns (B, 1, d)."""
    if hasattr(q, "device_mesh"):
        # DTensors: each rank attends with its own heads (q's split matches
        # the cache's K split, group for group); a cache whose sequence is
        # split over 'model' (K not divisible) is gathered first
        from torch.distributed.tensor import DTensor, Replicate

        mesh = q.device_mesh
        pl = [p_ if getattr(p_, "dim", None) in (0, 2) else Replicate()
              for p_ in keys.placements]
        q, keys, values = (t.redistribute(mesh, pl).to_local() for t in (q, keys, values))
        out = DTensor.from_local(_attend_local(q, keys, values, valid), mesh, pl,
                                 run_check=False)
        return _out_proj(out, p["wo"])
    return _out_proj(_attend_local(q, keys, values, valid), p["wo"])


def _attend_local(q, keys, values, valid) -> torch.Tensor:
    b, _, h, hd = q.shape
    kvh = keys.shape[2]
    qf = q.reshape(b, kvh, h // kvh, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qf, keys).to(torch.float32)
    scores = scores / math.sqrt(hd)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w.to(values.dtype), values)
    return out.reshape(b, 1, h, hd)


def attention_decode(p: dict, x: torch.Tensor, cfg, cache: KVCache, pos: int,
                     angles=None):
    """x: (B, 1, d); pos: the index of the new token (an int, the same for
    every row). Writes its k/v at ``pos`` in place and attends over
    cache[0..pos]. ``angles`` are the RoPE angles of ``pos``, computed once
    per step. Returns (out (B, 1, d), cache)."""
    if angles is None:
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
        angles = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q, k, v = _qkv(p, x, cfg, angles=angles)
    cache.k[:, pos] = k[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = v[:, 0].to(cache.v.dtype)
    valid = (torch.arange(cache.k.shape[1], device=x.device) <= pos)[None]
    return _attend_one(p, q, cache.k, cache.v, valid, cfg), cache


class PagedIndex(NamedTuple):
    """What one paged decode step computes once for all its layers: the
    physical (page, offset) each row writes its new k/v at, the valid
    positions of each row's gathered view, and the RoPE angles."""
    page_table: torch.Tensor  # (B, MP) int64
    write_page: torch.Tensor  # (B,) int64
    write_off: torch.Tensor   # (B,) int64
    valid: torch.Tensor       # (B, MP * page) bool
    angles: tuple             # (cos, sin), (B, 1, hd // 2) float32


def paged_index(cfg, page_table: torch.Tensor, lens: torch.Tensor, page: int) -> PagedIndex:
    table, lens = page_table.long(), lens.long()
    write_page = table.gather(1, (lens // page)[:, None])[:, 0]
    span = torch.arange(table.shape[1] * page, device=lens.device)
    return PagedIndex(table, write_page, lens % page, span[None, :] <= lens[:, None],
                      rope_angles(lens[:, None], cfg.resolved_head_dim, cfg.rope_theta))


def attention_decode_paged(p: dict, x: torch.Tensor, cfg, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lens: torch.Tensor, index: PagedIndex | None = None):
    """Paged-cache decode step for ONE layer.

    x: (B, 1, d); k_pool/v_pool: (NP, page, K, hd), this layer's slice of
    the global page pool (page id 0 is reserved scratch); page_table:
    (B, MP) page ids per slot; lens: (B,) tokens already cached per slot
    (the position the new token is written at). ``index`` is
    :func:`paged_index` of (page_table, lens), computed once per step.

    Slot j writes its new k/v at page ``page_table[j, lens[j] // page]``,
    offset ``lens[j] % page``, in place, then attends over the gathered
    ``(MP * page,)`` view of its own pages, masked at ``<= lens[j]``. With
    ``MP * page == max_len`` the gathered view has the dense cache's shape
    and values at every unmasked position, so the result equals
    :func:`attention_decode`'s bit for bit. Live slots own disjoint pages;
    idle slots all write to scratch page 0, which no live slot reads, so
    the duplicate indices of that write are harmless.

    Returns (out (B, 1, d), k_pool, v_pool)."""
    b = x.shape[0]
    hd, kvh = cfg.resolved_head_dim, cfg.num_kv_heads
    if index is None:
        index = paged_index(cfg, page_table, lens, k_pool.shape[1])
    q, k, v = _qkv(p, x, cfg, angles=index.angles)
    k_pool.index_put_((index.write_page, index.write_off), k[:, 0].to(k_pool.dtype))
    v_pool.index_put_((index.write_page, index.write_off), v[:, 0].to(v_pool.dtype))
    keys = k_pool[index.page_table].reshape(b, -1, kvh, hd)  # (B, MP*page, K, hd)
    values = v_pool[index.page_table].reshape(b, -1, kvh, hd)
    return _attend_one(p, q, keys, values, index.valid, cfg), k_pool, v_pool


# ---------------------------------------------------------------------------
# cross-attention (the encoder-decoder's decoder)
# ---------------------------------------------------------------------------


def init_cross_attention(gen: torch.Generator, cfg, lead=()) -> dict:
    return init_attention(gen, cfg, lead)


def cross_attention(p: dict, x: torch.Tensor, enc_kv, cfg) -> torch.Tensor:
    """x: (B, S, d) decoder states; enc_kv: (k, v), each (B, F, K, hd),
    from :func:`encode_cross_kv`. Returns (B, S, d)."""
    q = _project(x, p["wq"])
    k, v = _repeat_kv(enc_kv[0], enc_kv[1], cfg)
    return _out_proj(_attend(q, k, v, cfg, False), p["wo"])


def encode_cross_kv(p: dict, enc_out: torch.Tensor):
    """Encoder states (B, F, d) -> cross (k, v), each (B, F, K, hd)."""
    return _project(enc_out, p["wk"]), _project(enc_out, p["wv"])
