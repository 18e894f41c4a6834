"""Whisper-style encoder-decoder (torch port of ``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, F, d_model), which
``frame_proj`` maps into the encoder. The encoder is bidirectional
self-attention; the decoder is causal self-attention, then cross-attention
over the encoder states, then the MLP. Both apply RoPE over their positions
(the reference's docstring speaks of learned positions; its code applies
RoPE, and the port copies the code).

The parameters keep the reference's tree: ``embed``, ``enc_layers`` and
``dec_layers`` stacked ``(L, ...)``, ``enc_norm``, ``final_norm``, ``head``
and ``frame_proj``, registered in sorted-key order so that
``named_parameters()`` is the reference's flatten order (the FPISA blocks
are cut per flattened leaf). ``EncDecLM`` has ``TransformerLM``'s method
names; ``forward`` and ``loss`` take the batch dict with ``frames`` beside
``tokens``, so ``train/step.py``, ``launch/train.py`` and the aggregation
take it unchanged. Training recomputes each decoder layer's cross K/V from
the encoder states inside the layer, as the reference's scan body does.

Remat: ``remat="full"`` checkpoints each encoder and each decoder layer
(``torch.utils.checkpoint``, non-reentrant); ``"none"`` keeps every
activation; ``"dots"`` runs as ``"full"``, since the reference's
``encdec._remat`` checkpoints it without the policy.

Serving (``init_cache``, ``prefill``, ``decode_step``; the reference has no
paged path for this family) runs under ``torch.inference_mode()``.
``prefill`` encodes the frames, computes each layer's cross K/V ONCE and
stores them in the cache (cast to the cache dtype) beside the self-attention
K/V, and returns the last position's logits; ``decode_step`` appends one
token for every row at the shared position ``pos``. The serving engines
feed prompts alone, so they refuse this family (``serve.engine``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp,
    dtype_of,
    embed,
    init_embedding,
    init_lm_head,
    init_mlp,
    init_rms_norm,
    param,
    rms_norm,
    rope_angles,
)
from repro_torch.models.transformer import TreeLM, next_token_nll, reduced, unstack
from repro_torch.sharding.hints import constrain, entering


def _init_enc_layer(gen: torch.Generator, cfg, lead) -> dict:
    dt = dtype_of(cfg.param_dtype)
    return {"attn": attn.init_attention(gen, cfg, lead),
            "ln1": init_rms_norm(cfg.d_model, dt, gen.device, lead),
            "ln2": init_rms_norm(cfg.d_model, dt, gen.device, lead),
            "mlp": init_mlp(gen, cfg, lead)}


def _init_dec_layer(gen: torch.Generator, cfg, lead) -> dict:
    p = _init_enc_layer(gen, cfg, lead)
    p["lnx"] = init_rms_norm(cfg.d_model, dtype_of(cfg.param_dtype), gen.device, lead)
    p["xattn"] = attn.init_cross_attention(gen, cfg, lead)
    return p


def init_encdec(cfg, gen: torch.Generator) -> dict:
    """The reference's parameter tree (nested dicts of tensors), drawn from
    ``gen`` on its device."""
    dt = dtype_of(cfg.param_dtype)
    return {
        "embed": init_embedding(gen, cfg),
        "enc_layers": _init_enc_layer(gen, cfg, (cfg.num_encoder_layers,)),
        "dec_layers": _init_dec_layer(gen, cfg, (cfg.num_layers,)),
        "enc_norm": init_rms_norm(cfg.d_model, dt, gen.device),
        "final_norm": init_rms_norm(cfg.d_model, dt, gen.device),
        "head": init_lm_head(gen, cfg),
        # the frontend adapter for the stubbed conv features
        "frame_proj": {"w": param(gen, (cfg.d_model, cfg.d_model), dt)},
    }


def _enc_block(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor) -> torch.Tensor:
    eps = cfg.norm_eps
    x = x + reduced(attn.attention_train(lp["attn"], entering(rms_norm(x, lp["ln1"]["w"], eps)),
                                         cfg, positions, causal=False))
    return x + reduced(apply_mlp(lp["mlp"], entering(rms_norm(x, lp["ln2"]["w"], eps)), cfg))


def _dec_block(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               enc: torch.Tensor) -> torch.Tensor:
    eps = cfg.norm_eps
    kv = attn.encode_cross_kv(lp["xattn"], enc)
    x = x + reduced(attn.attention_train(lp["attn"], entering(rms_norm(x, lp["ln1"]["w"], eps)),
                                         cfg, positions))
    x = x + reduced(attn.cross_attention(lp["xattn"], entering(rms_norm(x, lp["lnx"]["w"], eps)),
                                         kv, cfg))
    return x + reduced(apply_mlp(lp["mlp"], entering(rms_norm(x, lp["ln2"]["w"], eps)), cfg))


class EncDecCache(NamedTuple):
    self_kv: attn.KVCache  # k, v: (L, B, max_len, K, hd)
    cross_kv: tuple        # (k, v), each (L, B, F, K, hd), written once by prefill
    pos: int               # tokens already in the self cache (the same for every row)


class EncDecLM(TreeLM):
    """Encoder-decoder LM; ``loss(batch)`` is the training objective,
    ``batch`` a dict of ``frames`` (B, F, d_model) and ``tokens`` (B, S)."""

    SELECTIVE_DOTS = False  # "dots" is "full" here (module doc)

    # --- training ------------------------------------------------------------

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype_of(self.cfg.activation_dtype))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.final_norm["w"], self.cfg.norm_eps) @ self.head["w"]

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, F, d_model) -> encoder states (B, F, d_model)."""
        cfg = self.cfg
        x = constrain(self._act(frames) @ self.frame_proj["w"], "batch", None, None)
        positions = torch.arange(x.shape[1], device=x.device)
        for lp in unstack(self.enc_layers):
            x = self._remat(lambda y, lp=lp: _enc_block(lp, y, cfg, positions), x)
        return rms_norm(x, self.enc_norm["w"], cfg.norm_eps)

    def forward(self, batch: dict):
        """batch -> (logits (B, S, V), aux 0)."""
        cfg = self.cfg
        enc = self.encode(batch["frames"])
        x = constrain(self._act(embed(self.embed, batch["tokens"])), "batch", None, None)
        positions = torch.arange(x.shape[1], device=x.device)
        for lp in unstack(self.dec_layers):
            x = self._remat(lambda y, e, lp=lp: _dec_block(lp, y, cfg, positions, e), x, enc)
        return self._head(x), torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token NLL of ``tokens[:, 1:]`` from float32
        log-probabilities."""
        logits, _ = self(batch)
        return next_token_nll(logits, batch["tokens"]).mean()

    # --- serving -----------------------------------------------------------

    def _dec_views(self) -> list:
        """Per-layer views of the stacked decoder weights, built once and
        kept while the leaves keep their storage."""
        key = tuple(t.data_ptr() for t in self.parameters())
        if key != self._views_key:
            self._views, self._views_key = unstack(self.dec_layers, detach=True), key
        return self._views

    @torch.inference_mode()
    def init_cache(self, batch: int, max_len: int) -> EncDecCache:
        """A zeroed cache for ``batch`` sequences of up to ``max_len``
        decoder tokens over ``num_frames`` frames, in the activation dtype,
        on this model's device."""
        cfg, dev = self.cfg, self.device
        dt = dtype_of(cfg.activation_dtype)
        tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
        shape = (cfg.num_layers, batch, max_len, *tail)
        xshape = (cfg.num_layers, batch, cfg.num_frames, *tail)
        zeros = lambda s: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
        return EncDecCache(attn.KVCache(zeros(shape), zeros(shape)),
                           (zeros(xshape), zeros(xshape)), 0)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache: EncDecCache, frames: torch.Tensor):
        """tokens (B, S) int and frames (B, F, d_model) -> (last-position
        logits (B, 1, V), the cache with its self K/V written at [0, S), its
        cross K/V written once, and ``pos`` S)."""
        cfg, eps = self.cfg, self.cfg.norm_eps
        enc = self.encode(frames)
        x = self._act(embed(self.embed, tokens))
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        xk, xv = cache.cross_kv
        for i, lp in enumerate(self._dec_views()):
            kv = attn.encode_cross_kv(lp["xattn"], enc)
            xk[i], xv[i] = kv[0].to(xk.dtype), kv[1].to(xv.dtype)
            row = attn.KVCache(cache.self_kv.k[i], cache.self_kv.v[i])
            x = x + attn.attention_prefill(lp["attn"], rms_norm(x, lp["ln1"]["w"], eps), cfg,
                                           positions, row)[0]
            x = x + attn.cross_attention(lp["xattn"], rms_norm(x, lp["lnx"]["w"], eps), kv, cfg)
            x = x + apply_mlp(lp["mlp"], rms_norm(x, lp["ln2"]["w"], eps), cfg)
        return self._head(x[:, -1:]), cache._replace(pos=tokens.shape[1])

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor, cache: EncDecCache):
        """tokens (B, 1) int -> (logits (B, 1, V), the cache with every
        row's self K/V written in place at ``pos`` and ``pos + 1``)."""
        cfg, eps, pos = self.cfg, self.cfg.norm_eps, cache.pos
        x = self._act(embed(self.embed, tokens))
        angles = rope_angles(torch.full((tokens.shape[0], 1), pos, device=tokens.device),
                             cfg.resolved_head_dim, cfg.rope_theta)
        xk, xv = cache.cross_kv
        for i, lp in enumerate(self._dec_views()):
            row = attn.KVCache(cache.self_kv.k[i], cache.self_kv.v[i])
            x = x + attn.attention_decode(lp["attn"], rms_norm(x, lp["ln1"]["w"], eps), cfg,
                                          row, pos, angles)[0]
            x = x + attn.cross_attention(lp["xattn"], rms_norm(x, lp["lnx"]["w"], eps),
                                         (xk[i], xv[i]), cfg)
            x = x + apply_mlp(lp["mlp"], rms_norm(x, lp["ln2"]["w"], eps), cfg)
        return self._head(x), cache._replace(pos=pos + 1)
