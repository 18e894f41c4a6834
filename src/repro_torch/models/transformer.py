"""TransformerLM for the dense family (torch port of ``repro.models.transformer``:
training, prefill and decode).

The parameters keep the reference's pytree layout, names and shapes: every
per-layer weight is ONE stacked ``(L, ...)`` leaf (``layers.attn.wq`` is
``(L, d, h, hd)``), and ``named_parameters()`` yields the leaves in the
reference's flatten order (sorted keys). The FPISA aggregation cuts its
blocks from each flattened leaf, so the layout decides which elements share
a block exponent: with the same leaves the aggregated bits are the same.

Serving (``init_cache``, ``prefill``, ``decode_step``,
``decode_step_paged``, the fields of the reference's ``Model`` tuple) runs
under ``torch.inference_mode()`` and writes the caches in place. Its
per-layer weight views are built once per module, not once per step.

Batch invariance. The continuous engine's greedy tokens are held to the
static engine run one request at a time, so a row's result must not depend
on how many rows share a call. In torch it does: a matrix product picks its
kernel, and with it the summation order, by the row count (one row takes a
matrix-vector product). So ``prefill`` runs one sequence per pass (every
product of an S-token prompt has S rows, however many prompts came
together), and a decode step runs in tiles of ``DECODE_ROWS`` rows (fewer
live rows are padded, and the padding rows' results are dropped): every
decode product has the same shape whatever the batch. A decode cache
therefore holds a multiple of ``DECODE_ROWS`` rows.

Remat is not applied (it has no numeric effect); the MoE, SSM, hybrid and
VLM families are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from repro_torch import NotPortedError
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp,
    dtype_of,
    embed,
    init_embedding,
    init_mlp,
    init_rms_norm,
    param,
    rms_norm,
    rope_angles,
)

# the row tile of a decode step (module doc, "Batch invariance")
DECODE_ROWS = 16


def _params(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})


def init_lm(cfg, gen: torch.Generator) -> dict:
    """The reference's parameter tree (nested dicts of tensors, sorted keys),
    drawn from ``gen`` on its device."""
    if cfg.family != "dense":
        raise NotPortedError(f"the {cfg.family!r} model family")
    dt, lead = dtype_of(cfg.param_dtype), (cfg.num_layers,)
    layers = {
        "attn": attn.init_attention(gen, cfg, lead),
        "ln1": init_rms_norm(cfg.d_model, dt, gen.device, lead),
        "ln2": init_rms_norm(cfg.d_model, dt, gen.device, lead),
        "mlp": init_mlp(gen, cfg, lead),
    }
    params = {
        "embed": init_embedding(gen, cfg),
        "final_norm": init_rms_norm(cfg.d_model, dt, gen.device),
        "head": {},
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": param(gen, (cfg.d_model, cfg.vocab_size), dt)}
    return params


def _dense_block(lp: dict, x: torch.Tensor, cfg, attend) -> torch.Tensor:
    """One pre-norm block: ``attend`` maps the normed input to the
    attention output (training, prefill or a decode form)."""
    x = x + attend(rms_norm(x, lp["ln1"]["w"], cfg.norm_eps))
    return x + apply_mlp(lp["mlp"], rms_norm(x, lp["ln2"]["w"], cfg.norm_eps), cfg)


def _per_layer(layers: nn.ModuleDict, num_layers: int, detach: bool = False) -> list:
    """Split the stacked leaves into per-layer views (one ``unbind`` per
    leaf, whose backward stacks the per-layer gradients back; ``detach``:
    views outside autograd, for serving)."""
    split = {g: {k: (t.detach() if detach else t).unbind(0) for k, t in group.items()}
             for g, group in layers.items()}
    return [{g: {k: ts[i] for k, ts in group.items()} for g, group in split.items()}
            for i in range(num_layers)]


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def decode_rows(batch: int) -> int:
    """Rows a decode step computes for ``batch`` rows: a multiple of
    ``DECODE_ROWS``."""
    return max(1, -(-batch // DECODE_ROWS)) * DECODE_ROWS


class LMCache(NamedTuple):
    kv: attn.KVCache  # k, v: (L, rows, max_len, K, hd)
    pos: int          # tokens already in the cache (the same for every row)


def select_rows(cache: LMCache, idx) -> LMCache:
    """The cache's rows ``idx`` (a list of row indices), padded to
    ``decode_rows(len(idx))`` rows with copies of row ``idx[0]``: a new
    cache (the static engine's retirement)."""
    idx = list(idx)
    idx = idx + idx[:1] * (decode_rows(len(idx)) - len(idx))
    rows = torch.tensor(idx, device=cache.kv.k.device)
    return LMCache(attn.KVCache(cache.kv.k[:, rows], cache.kv.v[:, rows]), cache.pos)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0], *t.shape[1:]))])


class TransformerLM(nn.Module):
    """Dense decoder LM; ``loss(tokens)`` is the training objective."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        # registration order = the reference's flatten order
        self.embed = _params(params["embed"])
        self.final_norm = _params(params["final_norm"])
        self.head = _params(params["head"])
        self.layers = nn.ModuleDict({g: _params(t) for g, t in params["layers"].items()})
        self._views, self._views_key = None, None

    def forward(self, tokens: torch.Tensor):
        """tokens (B, S) int -> (logits (B, S, V), aux_loss)."""
        cfg = self.cfg
        x = embed(self.embed, tokens).to(dtype_of(cfg.activation_dtype))
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for lp in _per_layer(self.layers, cfg.num_layers):
            x = _dense_block(lp, x, cfg,
                             lambda y: attn.attention_train(lp["attn"], y, cfg, positions))
        x = rms_norm(x, self.final_norm["w"], cfg.norm_eps)
        w = self.embed["tok"].T if cfg.tie_embeddings else self.head["w"]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)  # dense: none
        return x @ w, aux

    def loss(self, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token NLL + 0.01 * aux, from float32 log-probabilities."""
        logits, aux = self(tokens)
        lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
        nll = -lp.gather(-1, tokens[:, 1:, None].long())[..., 0]
        return nll.mean() + 0.01 * aux

    # --- serving -----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def _serving_layers(self) -> list:
        """Per-layer views of the stacked weights, built once and kept while
        the leaves keep their storage (in-place updates show through)."""
        key = tuple(t.data_ptr() for t in self.layers.parameters())
        if key != self._views_key:
            self._views = _per_layer(self.layers, self.cfg.num_layers, detach=True)
            self._views_key = key
        return self._views

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed(self.embed, tokens).to(dtype_of(self.cfg.activation_dtype))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm["w"], cfg.norm_eps)
        w = self.embed["tok"].T if cfg.tie_embeddings else self.head["w"]
        return x @ w

    @torch.inference_mode()
    def init_cache(self, batch: int, max_len: int, *, rows: int | None = None) -> LMCache:
        """A zeroed dense cache for ``batch`` sequences of up to ``max_len``
        tokens on this model's device, in the activation dtype. It holds
        ``decode_rows(batch)`` rows so that ``decode_step`` can run on it;
        a cache that only ``prefill`` fills may ask for ``rows=batch``."""
        cfg = self.cfg
        if cfg.family != "dense":
            raise NotPortedError(f"serving the {cfg.family!r} model family")
        rows = decode_rows(batch) if rows is None else rows
        shape = (cfg.num_layers, rows, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        dt = dtype_of(cfg.activation_dtype)
        return LMCache(attn.KVCache(torch.zeros(shape, dtype=dt, device=self.device),
                                    torch.zeros(shape, dtype=dt, device=self.device)), 0)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache: LMCache):
        """tokens (B, S) int -> (last-position logits (B, 1, V), the cache
        with rows [0, B) filled at [0, S) and ``pos`` S). One pass per
        sequence (module doc); the final norm and head see the last
        position only."""
        cfg = self.cfg
        s = tokens.shape[1]
        positions = torch.arange(s, device=tokens.device)
        layers = self._serving_layers()
        logits = []
        for j in range(tokens.shape[0]):
            x = self._embed(tokens[j:j + 1])
            for i, lp in enumerate(layers):
                row = attn.KVCache(cache.kv.k[i, j:j + 1], cache.kv.v[i, j:j + 1])
                x = _dense_block(lp, x, cfg, lambda y: attn.attention_prefill(
                    lp["attn"], y, cfg, positions, row)[0])
            logits.append(self._logits(x[:, -1:]))
        return torch.cat(logits), cache._replace(pos=s)

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor, cache: LMCache):
        """tokens (B, 1) int, B at most the cache's rows -> (logits (B, 1,
        V), the cache with every row's k/v written at ``pos`` in place and
        ``pos + 1``)."""
        cfg = self.cfg
        b, rows = tokens.shape[0], cache.kv.k.shape[1]
        if rows % DECODE_ROWS or b > rows:
            raise ValueError(f"decode_step takes at most the cache's {rows} rows, a multiple "
                             f"of DECODE_ROWS={DECODE_ROWS}; got {b} tokens")
        toks, pos = _pad_rows(tokens, rows), cache.pos
        angles = rope_angles(torch.full((DECODE_ROWS, 1), pos, device=tokens.device),
                             cfg.resolved_head_dim, cfg.rope_theta)
        layers = self._serving_layers()
        logits = []
        for r in range(0, rows, DECODE_ROWS):
            tile = slice(r, r + DECODE_ROWS)
            x = self._embed(toks[tile])
            for i, lp in enumerate(layers):
                row = attn.KVCache(cache.kv.k[i, tile], cache.kv.v[i, tile])
                x = _dense_block(lp, x, cfg, lambda y: attn.attention_decode(
                    lp["attn"], y, cfg, row, pos, angles)[0])
            logits.append(self._logits(x))
        return torch.cat(logits)[:b], cache._replace(pos=pos + 1)

    @torch.inference_mode()
    def decode_step_paged(self, tokens: torch.Tensor, k_pools: torch.Tensor,
                          v_pools: torch.Tensor, page_table: torch.Tensor,
                          lens: torch.Tensor):
        """Per-slot decode through a paged KV pool (continuous batching).

        tokens: (B, 1) int; k_pools/v_pools: (L, NP, page, K, hd) global
        page pools, written in place; page_table: (B, MP) page ids;
        lens: (B,) per-slot cache lengths, the position each slot's new
        token is written at. Returns (logits (B, 1, V), k_pools, v_pools)."""
        cfg = self.cfg
        b = tokens.shape[0]
        rows = decode_rows(b)
        toks, table, lens = (_pad_rows(t, rows) for t in (tokens, page_table, lens))
        layers = self._serving_layers()
        logits = []
        for r in range(0, rows, DECODE_ROWS):
            tile = slice(r, r + DECODE_ROWS)
            index = attn.paged_index(cfg, table[tile], lens[tile], k_pools.shape[2])
            x = self._embed(toks[tile])
            for i, lp in enumerate(layers):
                x = _dense_block(lp, x, cfg, lambda y: attn.attention_decode_paged(
                    lp["attn"], y, cfg, k_pools[i], v_pools[i], table[tile], lens[tile],
                    index)[0])
            logits.append(self._logits(x))
        return torch.cat(logits)[:b], k_pools, v_pools
