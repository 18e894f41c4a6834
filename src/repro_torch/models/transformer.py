"""TransformerLM for the decoder-only families: dense, moe, ssm, hybrid and
vlm (torch port of ``repro.models.transformer``: training, prefill and
decode).

The parameters keep the reference's pytree layout, names and shapes: every
per-layer weight is ONE stacked ``(L, ...)`` leaf (``layers.attn.wq`` is
``(L, d, h, hd)``; the hybrid's ``layers`` are ``(ngroups, every, ...)``
with ``tail_layers`` ``(L - ngroups * every, ...)`` beside them), and
``named_parameters()`` yields the leaves in the reference's flatten order
(sorted keys). The FPISA aggregation cuts its blocks from each flattened
leaf, so the layout decides which elements share a block exponent: with the
same leaves the aggregated bits are the same.

Families. moe: the feed-forward of every block is ``models/moe.py`` (plus
arctic's parallel ``dense_mlp``), and the loss adds ``0.01 *`` the summed
load-balance loss. ssm: mamba2 blocks (``models/mamba2.py``). hybrid
(zamba2): ``hybrid_attn_every`` mamba blocks, then ONE ``shared`` dense
block (the same weights at every application, one KV cache each), then the
tail mamba blocks. zamba2 (the port's own: the published Zamba2 hybrid,
``models/zamba2.py``): every layer's mamba block, shared blocks over the
embedding's concatenation before the layers ``hybrid_layer_ids``, each
application with its own adapter; it trains, and its serving methods
raise. vlm: ``vlm_proj`` projects ``patch_embeds`` (B, P, d)
into a prefix of the sequence, and the loss is taken on the tokens after
it; a batch without ``patch_embeds`` has no prefix (the reference's
function with P = 0), which is how the engines serve text prompts.

Remat. ``remat="full"`` recomputes each layer's body in the backward
(``torch.utils.checkpoint``, non-reentrant; for the hybrid, each group of
``every`` mamba blocks and its shared block, and each tail block, as the
reference's scan bodies), ``"none"`` keeps every activation. ``"dots"``
(no config uses it) checkpoints the same bodies selectively
(:func:`dots_policy`): the backward keeps the outputs of the products that
have no batch dimension and recomputes the rest, as the reference's
``dots_with_no_batch_dims_saveable``; like the reference, it keeps no
product whose output no backward reads (``layers.unread_product``: the
MLP's down projection, mamba's ``out_proj``). None of the three changes a
value. ``flash_remat`` and ``seq_parallel``
change only memory and sharding; ``attn_q_chunk`` sets the chunks of the
online softmax (``models/attention.py::chunked_attention``), and with them
the order of its float32 additions, as in the reference.

Serving (``init_cache``, ``prefill``, ``decode_step``,
``decode_step_paged``, the fields of the reference's ``Model`` tuple) runs
under ``torch.inference_mode()`` and writes the caches in place. Its
per-layer weight views are built once per module, not once per step.

Batch invariance. The continuous engine's greedy tokens are held to the
static engine run one request at a time, so a row's result must not depend
on how many rows share a call. In torch it does: a matrix product picks its
kernel, and with it the summation order, by the row count (one row takes a
matrix-vector product). So ``prefill`` runs every product one sequence at
a time (every product of an S-token prompt has S rows, however many prompts
came together), and a decode step runs its products in tiles of
``DECODE_ROWS`` rows (fewer live rows are padded, and the padding rows'
results are dropped): every decode product has the same shape whatever the
batch. A decode cache therefore holds a multiple of ``DECODE_ROWS`` rows.
The layers run outermost: the MoE dispatch of a layer takes every real row
of the call at once (the reference groups ``moe_group_size`` tokens of the
whole batch), and never the padding rows. So moe rows depend on their batch
by the reference's design; the other families' do not.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import NotPortedError
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe, zamba2
from repro_torch.models.layers import (
    apply_mlp,
    dtype_of,
    embed,
    in_unread_product,
    init_embedding,
    init_lm_head,
    init_mlp,
    init_rms_norm,
    param,
    rms_norm,
    rope_angles,
)
from repro_torch.sharding.hints import constrain, entering, local_product

# the row tile of a decode step (module doc, "Batch invariance")
DECODE_ROWS = 16
ATTN_FAMILIES = ("dense", "moe", "vlm")   # families whose cache is K/V only
REMATS = ("none", "full", "dots")
# the products with no batch dimension: a layer writes each of them as
# ``x @ W`` with a 2-D weight, which torch folds into one of these; an
# einsum with a batch dimension reaches the policy as ``bmm`` or ``baddbmm``
NO_BATCH_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``'s selective checkpointing: save the output of a
    product with no batch dimension unless no backward reads it
    (``layers.unread_product``), recompute everything else (the batched
    products, norms, activations, RoPE, collectives, A1's forward)."""
    if op in NO_BATCH_PRODUCTS and not in_unread_product():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _tree_module(tree: dict) -> nn.Module:
    """A parameter tree as modules, keys sorted (the reference's flatten
    order): a dict of tensors is a ParameterDict, a dict of dicts a
    ModuleDict."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(tree[k]) for k in sorted(tree)})
    return nn.ModuleDict({k: _tree_module(tree[k]) for k in sorted(tree)})


def _init_dense_layer(gen: torch.Generator, cfg, lead=()) -> dict:
    dt = dtype_of(cfg.param_dtype)
    p = {"attn": attn.init_attention(gen, cfg, lead),
         "ln1": init_rms_norm(cfg.d_model, dt, gen.device, lead),
         "ln2": init_rms_norm(cfg.d_model, dt, gen.device, lead)}
    if cfg.family == "moe":
        p["moe"] = moe.init_moe(gen, cfg, lead)
        if cfg.moe_dense_ff:
            p["dense_mlp"] = init_mlp(gen, cfg, lead, d_ff=cfg.moe_dense_ff)
    else:
        p["mlp"] = init_mlp(gen, cfg, lead)
    return p


def _init_mamba_layer(gen: torch.Generator, cfg, lead=()) -> dict:
    dt = dtype_of(cfg.param_dtype)
    return {"ln1": init_rms_norm(cfg.d_model, dt, gen.device, lead),
            "mamba": mamba2.init_mamba2(gen, cfg, lead)}


def hybrid_groups(cfg) -> tuple[int, int]:
    """(ngroups, grouped layers) of a hybrid config."""
    ng = cfg.num_layers // cfg.hybrid_attn_every
    return ng, ng * cfg.hybrid_attn_every


def init_lm(cfg, gen: torch.Generator) -> dict:
    """The reference's parameter tree (nested dicts of tensors), drawn from
    ``gen`` on its device."""
    dt, lead = dtype_of(cfg.param_dtype), (cfg.num_layers,)
    params = {"embed": init_embedding(gen, cfg)}
    if cfg.family in ATTN_FAMILIES:
        params["layers"] = _init_dense_layer(gen, cfg, lead)
    elif cfg.family == "ssm":
        params["layers"] = _init_mamba_layer(gen, cfg, lead)
    elif cfg.family == "hybrid":
        ng, grouped = hybrid_groups(cfg)
        stacked = _init_mamba_layer(gen, cfg, lead)
        params["layers"] = _tree_map(
            lambda x: x[:grouped].reshape(ng, cfg.hybrid_attn_every, *x.shape[1:]).clone(), stacked)
        params["tail_layers"] = _tree_map(lambda x: x[grouped:].clone(), stacked)
        params["shared"] = _init_dense_layer(gen, cfg.with_(family="dense"))
    elif cfg.family == zamba2.FAMILY:
        params.update(zamba2.init_zamba2(cfg, gen))
    else:
        raise NotPortedError(f"the {cfg.family!r} model family")
    params["final_norm"] = init_rms_norm(cfg.d_model, dt, gen.device)
    params["head"] = init_lm_head(gen, cfg)
    if cfg.family == "vlm":
        params["vlm_proj"] = {"w": param(gen, (cfg.d_model, cfg.d_model), dt)}
    return params


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def unstack(node, detach: bool = False) -> list:
    """Split a stacked tree along its first axis into per-layer trees of
    views (one ``unbind`` per leaf, whose backward stacks the per-layer
    gradients back; ``detach``: views outside autograd, for serving)."""
    if isinstance(node, torch.Tensor):
        return list((node.detach() if detach else node).unbind(0))
    parts = {k: unstack(v, detach) for k, v in node.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _ffn(lp: dict, y: torch.Tensor, cfg):
    """The block's feed-forward on normed ``y``: (out, aux)."""
    if "moe" in lp:
        out, aux = moe.apply_moe(lp["moe"], y, cfg)
        if "dense_mlp" in lp:
            out = out + apply_mlp(lp["dense_mlp"], y, cfg)
        return out, aux
    return apply_mlp(lp["mlp"], y, cfg), torch.zeros((), dtype=torch.float32, device=y.device)


def _sp(x: torch.Tensor, cfg) -> torch.Tensor:
    """Sequence parallelism (Megatron SP): between the TP segments the
    residual stream shards its seq axis over 'model'."""
    if not cfg.seq_parallel:
        return x
    return constrain(x, "batch", "model", None)


def reduced(h: torch.Tensor) -> torch.Tensor:
    """A block's output in the residual stream's layout (batch over the
    replica axes, the rest replicated). On a mesh, a product that contracts
    a 'model'-sharded axis leaves a partial sum; it is reduced here, where
    the reference's partitioner reduces it, so that the next products see
    a replicated input and keep their weights sharded."""
    return constrain(h, "batch", None, None)


def _dense_block(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    h = attn.attention_train(lp["attn"], entering(rms_norm(x, lp["ln1"]["w"], cfg.norm_eps)),
                             cfg, positions)
    x = _sp(x + reduced(h), cfg)
    out, aux = _ffn(lp, entering(rms_norm(x, lp["ln2"]["w"], cfg.norm_eps)), cfg)
    return _sp(x + reduced(out), cfg), aux


def _mamba_block(lp: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    h, _, _ = mamba2.apply_mamba2(lp["mamba"], rms_norm(x, lp["ln1"]["w"], cfg.norm_eps), cfg)
    return x + reduced(h)


# ---------------------------------------------------------------------------
# serving helpers
# ---------------------------------------------------------------------------


def decode_rows(batch: int) -> int:
    """Rows a decode step computes for ``batch`` rows: a multiple of
    ``DECODE_ROWS``."""
    return max(1, -(-batch // DECODE_ROWS)) * DECODE_ROWS


class LMCache(NamedTuple):
    kv: attn.KVCache | None          # k, v: (L or ngroups, rows, max_len, K, hd)
    pos: int                         # tokens already in the cache (the same for every row)
    ssm: torch.Tensor | None = None  # (L, rows, H, P, N) float32
    conv: torch.Tensor | None = None  # (L, rows, w - 1, C)


def select_rows(cache: LMCache, idx) -> LMCache:
    """The cache's rows ``idx`` (a list of row indices), padded to
    ``decode_rows(len(idx))`` rows with copies of row ``idx[0]``: a new
    cache (the static engine's retirement)."""
    idx = list(idx)
    idx = idx + idx[:1] * (decode_rows(len(idx)) - len(idx))
    some = cache.kv.k if cache.kv is not None else cache.ssm
    rows = torch.tensor(idx, device=some.device)
    kv = None if cache.kv is None else attn.KVCache(cache.kv.k[:, rows], cache.kv.v[:, rows])
    ssm = None if cache.ssm is None else cache.ssm[:, rows]
    conv = None if cache.conv is None else cache.conv[:, rows]
    return LMCache(kv, cache.pos, ssm, conv)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0], *t.shape[1:]))])


def _serve_dense_layer(lp: dict, xs: list, cfg, attend, valid: int) -> list:
    """One dense / moe block over the chunks ``xs`` (one sequence each in
    prefill, one row tile each in decode). ``attend(i, y)`` is chunk i's
    attention output. Every product runs per chunk except the MoE dispatch,
    which takes the first ``valid`` rows of all chunks together (module
    doc); the rest of its output is zero."""
    eps = cfg.norm_eps
    xs = [x + attend(i, rms_norm(x, lp["ln1"]["w"], eps)) for i, x in enumerate(xs)]
    ys = [rms_norm(x, lp["ln2"]["w"], eps) for x in xs]
    if "moe" in lp:
        y = torch.cat(ys)
        out, _ = moe.apply_moe(lp["moe"], y[:valid], cfg)
        outs = list(_pad_rows(out, y.shape[0]).split([c.shape[0] for c in ys]))
        if "dense_mlp" in lp:
            outs = [o + apply_mlp(lp["dense_mlp"], yc, cfg) for o, yc in zip(outs, ys)]
    else:
        outs = [apply_mlp(lp["mlp"], y, cfg) for y in ys]
    return [x + o for x, o in zip(xs, outs)]


def _serve_mamba_layer(lp: dict, xs: list, cfg, run) -> list:
    """One mamba block over the chunks; ``run(i, y)`` is chunk i's mamba
    output (it writes the chunk's states into the cache)."""
    return [x + run(i, rms_norm(x, lp["ln1"]["w"], cfg.norm_eps)) for i, x in enumerate(xs)]


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(B, T - 1) NLL of ``tokens[:, 1:]`` under the logits of the last T
    positions (a vlm's patch prefix comes first). DTensor logits are never
    sliced: DTensor's slice backward gathers a vocab-sharded gradient
    whole, so every position is scored (the prefix and the last against a
    padding target) and the (B, S) result is sliced instead."""
    prefix = logits.shape[1] - tokens.shape[1]
    if _vocab_split(logits):  # targets as this rank's rows of plain tokens
        local = tokens.to_local() if hasattr(tokens, "device_mesh") else tokens
        targets = torch.nn.functional.pad(local[:, 1:], (prefix, 1))
        return token_nll(logits, targets)[:, prefix:-1]
    return token_nll(logits[:, prefix:][:, :-1], tokens[:, 1:])


def _vocab_split(logits) -> bool:
    """Whether DTensor logits split their vocab axis over more than one
    rank."""
    return hasattr(logits, "device_mesh") and any(
        getattr(p, "dim", None) in (-1, logits.ndim - 1) and logits.device_mesh.size(i) > 1
        for i, p in enumerate(logits.placements))


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[target] per position, from float32 logits.
    DTensor logits whose vocab axis is split (a mesh step; ``targets`` then
    plain, this rank's rows) take the vocab-parallel form: the max and the sum of exponentials reduce over
    the vocab shards, and each rank contributes its shard's target logits
    (others zero), so the logits are never gathered whole."""
    if _vocab_split(logits):
        return _vocab_parallel_nll(logits, targets)
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -lp.gather(-1, targets[..., None].long())[..., 0]


def _vocab_parallel_nll(logits, targets: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.sharding.rules import local_range

    mesh, last = logits.device_mesh, logits.ndim - 1
    x = logits.to(torch.float32)
    m = x.detach().amax(dim=-1, keepdim=True).full_tensor()
    lse = torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]
    v0, vn = local_range(x.shape[last], mesh, x.placements, last, x.ndim)
    vocab_pl = [Partial() if isinstance(p, Shard) and p.dim in (-1, last) else p
                for p in x.placements]
    local = x.to_local(grad_placements=x.placements)
    t = targets.long() - v0
    mine = (t >= 0) & (t < vn)
    picked = local.gather(-1, t.clamp(0, vn - 1)[..., None])[..., 0]
    picked = DTensor.from_local(torch.where(mine, picked, 0.0), mesh, vocab_pl, run_check=False)
    return lse - picked


class TreeLM(nn.Module):
    """What the port's models share: the reference's parameter tree,
    registered in sorted-key order (the reference's flatten order), and
    remat (``_remat`` checkpoints one layer's body: whole, or under
    :func:`dots_policy` for ``"dots"`` where ``SELECTIVE_DOTS``)."""

    SELECTIVE_DOTS = True

    def __init__(self, cfg, params: dict):
        super().__init__()
        if cfg.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {cfg.remat!r}")
        self.cfg = cfg
        for k in sorted(params):
            setattr(self, k, _tree_module(params[k]))
        self._views, self._views_key = None, None

    def _remat(self, fn, *args):
        if self.cfg.remat == "none" or not torch.is_grad_enabled():
            return fn(*args)
        if self.cfg.remat == "dots" and self.SELECTIVE_DOTS:
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=lambda: create_selective_checkpoint_contexts(dots_policy))
        return checkpoint(fn, *args, use_reentrant=False)

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device


class TransformerLM(TreeLM):
    """Decoder LM of any decoder-only family; ``loss(batch)`` is the
    training objective, ``batch`` a dict of ``tokens`` (B, S) and, for vlm,
    ``patch_embeds`` (B, P, d). The port's zamba2 family
    (``models/zamba2.py``) trains only: its serving methods raise."""

    def __init__(self, cfg, params: dict):
        if cfg.family == zamba2.FAMILY:
            zamba2.check_config(cfg)
        super().__init__(cfg, params)

    def _check_serves(self) -> None:
        if self.cfg.family == zamba2.FAMILY:
            raise zamba2.unsupported("serving path (init_cache, prefill, decode)")

    # --- training ------------------------------------------------------------

    def _input_embeds(self, tokens: torch.Tensor, patch_embeds=None) -> torch.Tensor:
        x = embed(self.embed, tokens)
        if self.cfg.family == "vlm" and patch_embeds is not None:
            patches = patch_embeds.to(x.dtype) @ self.vlm_proj["w"]
            x = torch.cat([patches, x], dim=1)
        # anchor the activation layout: batch over replica axes, d_model
        # replicated (TP reshards at the products)
        x = constrain(x, "batch", None, None)
        return x.to(dtype_of(self.cfg.activation_dtype))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm["w"], cfg.norm_eps)
        w = self.embed["tok"].T if cfg.tie_embeddings else self.head["w"]
        if hasattr(w, "device_mesh"):  # vocab split over 'model' at most
            return constrain(local_product(x, w, 1), "batch", None, "model")
        return constrain(x @ w, "batch", None, "model")

    def forward(self, batch: dict):
        """batch -> (logits (B, S', V), aux_loss), S' counting a vlm's
        patch prefix."""
        cfg = self.cfg
        x = self._input_embeds(batch["tokens"], batch.get("patch_embeds"))
        positions = torch.arange(x.shape[1], device=x.device)
        auxes = []
        if cfg.family in ATTN_FAMILIES:
            for lp in unstack(self.layers):
                x, aux = self._remat(lambda y, lp=lp: _dense_block(lp, y, cfg, positions), x)
                auxes.append(aux)
        elif cfg.family == "ssm":
            for lp in unstack(self.layers):
                x = self._remat(lambda y, lp=lp: _mamba_block(lp, y, cfg), x)
        elif cfg.family == zamba2.FAMILY:
            x = zamba2.run_layers(self, x, positions)
        else:  # hybrid
            def group(y, glp):
                for lp in unstack(glp):
                    y = _mamba_block(lp, y, cfg)
                return _dense_block(self.shared, y, cfg, positions)[0]

            for glp in unstack(self.layers):
                x = self._remat(lambda y, glp=glp: group(y, glp), x)
            for lp in unstack(self.tail_layers):
                x = self._remat(lambda y, lp=lp: _mamba_block(lp, y, cfg), x)
        aux = (torch.stack(auxes).sum() if auxes
               else torch.zeros((), dtype=torch.float32, device=x.device))
        return self._head(x), aux

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token NLL (after a vlm's patches) + 0.01 * aux, from
        float32 log-probabilities."""
        logits, aux = self(batch)
        tokens = batch["tokens"]
        return next_token_nll(logits, tokens).mean() + 0.01 * aux

    # --- serving -----------------------------------------------------------

    def _serving_views(self) -> dict:
        """Per-layer views of the stacked weights, built once and kept while
        the leaves keep their storage (in-place updates show through):
        ``layers`` (per group, a list of layers, for the hybrid), ``tail``
        and ``shared``."""
        key = tuple(t.data_ptr() for t in self.parameters())
        if key != self._views_key:
            layers = unstack(self.layers, detach=True)
            views = {"layers": layers}
            if self.cfg.family == "hybrid":
                views = {"layers": [unstack(g) for g in layers],
                         "tail": unstack(self.tail_layers, detach=True),
                         "shared": self.shared}
            self._views, self._views_key = views, key
        return self._views

    @torch.inference_mode()
    def init_cache(self, batch: int, max_len: int, *, rows: int | None = None) -> LMCache:
        """A zeroed cache for ``batch`` sequences of up to ``max_len``
        tokens (a vlm's patch prefix included) on this model's device. It
        holds ``decode_rows(batch)`` rows so that ``decode_step`` can run
        on it; a cache that only ``prefill`` fills may ask for
        ``rows=batch``. K/V (attention families, and one per shared-block
        application of the hybrid) in the activation dtype; SSM states
        float32, conv states in the activation dtype."""
        self._check_serves()
        cfg, dev = self.cfg, self.device
        rows = decode_rows(batch) if rows is None else rows
        dt = dtype_of(cfg.activation_dtype)
        kv = ssm = conv = None
        kv_layers = hybrid_groups(cfg)[0] if cfg.family == "hybrid" else cfg.num_layers
        if cfg.family != "ssm":
            shape = (kv_layers, rows, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
            kv = attn.KVCache(torch.zeros(shape, dtype=dt, device=dev),
                              torch.zeros(shape, dtype=dt, device=dev))
        if cfg.family in ("ssm", "hybrid"):
            s0, c0 = mamba2.init_ssm_state(rows, cfg, dev)
            ssm = s0.expand(cfg.num_layers, *s0.shape).clone()
            conv = c0.expand(cfg.num_layers, *c0.shape).clone()
        return LMCache(kv, 0, ssm, conv)

    def _run_layers(self, xs: list, attend_at, mamba_at, valid: int) -> list:
        """Every block of the model over the chunks ``xs``.
        ``attend_at(lp, kv_layer)`` and ``mamba_at(lp, layer)`` build a
        block's per-chunk function (prefill or decode form)."""
        cfg = self.cfg
        views = self._serving_views()
        if cfg.family in ATTN_FAMILIES:
            for i, lp in enumerate(views["layers"]):
                xs = _serve_dense_layer(lp, xs, cfg, attend_at(lp, i), valid)
        elif cfg.family == "ssm":
            for i, lp in enumerate(views["layers"]):
                xs = _serve_mamba_layer(lp, xs, cfg, mamba_at(lp, i))
        else:  # hybrid
            every, shared = cfg.hybrid_attn_every, views["shared"]
            for g, group in enumerate(views["layers"]):
                for j, lp in enumerate(group):
                    xs = _serve_mamba_layer(lp, xs, cfg, mamba_at(lp, g * every + j))
                xs = _serve_dense_layer(shared, xs, cfg, attend_at(shared, g), valid)
            grouped = hybrid_groups(cfg)[1]
            for j, lp in enumerate(views["tail"]):
                xs = _serve_mamba_layer(lp, xs, cfg, mamba_at(lp, grouped + j))
        return xs

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache: LMCache, patch_embeds=None):
        """tokens (B, S) int (and, for vlm, ``patch_embeds`` (B, P, d) or
        None) -> (last-position logits (B, 1, V), the cache with rows [0,
        B) filled at [0, P + S) and ``pos`` P + S). Every product runs one
        sequence at a time (module doc); the final norm and head see the
        last position only."""
        self._check_serves()
        cfg = self.cfg
        b = tokens.shape[0]
        xs = [self._input_embeds(tokens[j:j + 1],
                                 None if patch_embeds is None else patch_embeds[j:j + 1])
              for j in range(b)]
        s = xs[0].shape[1]
        positions = torch.arange(s, device=tokens.device)

        def attend_at(lp, layer):
            def run(j, y):
                row = attn.KVCache(cache.kv.k[layer, j:j + 1], cache.kv.v[layer, j:j + 1])
                return attn.attention_prefill(lp["attn"], y, cfg, positions, row)[0]
            return run

        def mamba_at(lp, layer):
            def run(j, y):
                h, state, conv = mamba2.apply_mamba2(lp["mamba"], y, cfg)
                cache.ssm[layer, j] = state[0]
                cache.conv[layer, j] = conv[0].to(cache.conv.dtype)
                return h
            return run

        xs = self._run_layers(xs, attend_at, mamba_at, valid=b)
        logits = [self._head(x[:, -1:]) for x in xs]
        return torch.cat(logits), cache._replace(pos=s)

    def _tiles(self, tokens: torch.Tensor, rows: int):
        toks = _pad_rows(tokens, rows)
        tiles = [slice(r, r + DECODE_ROWS) for r in range(0, rows, DECODE_ROWS)]
        return tiles, [self._input_embeds(toks[t]) for t in tiles]

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor, cache: LMCache):
        """tokens (B, 1) int, B at most the cache's rows -> (logits (B, 1,
        V), the cache with every row's k/v (or SSM and conv states) written
        in place at ``pos`` and ``pos + 1``)."""
        self._check_serves()
        cfg = self.cfg
        some = cache.kv.k if cache.kv is not None else cache.ssm
        b, rows = tokens.shape[0], some.shape[1]
        if rows % DECODE_ROWS or b > rows:
            raise ValueError(f"decode_step takes at most the cache's {rows} rows, a multiple "
                             f"of DECODE_ROWS={DECODE_ROWS}; got {b} tokens")
        pos = cache.pos
        angles = rope_angles(torch.full((DECODE_ROWS, 1), pos, device=tokens.device),
                             cfg.resolved_head_dim, cfg.rope_theta)
        tiles, xs = self._tiles(tokens, rows)

        def attend_at(lp, layer):
            def run(i, y):
                row = attn.KVCache(cache.kv.k[layer, tiles[i]], cache.kv.v[layer, tiles[i]])
                return attn.attention_decode(lp["attn"], y, cfg, row, pos, angles)[0]
            return run

        def mamba_at(lp, layer):
            def run(i, y):
                t = tiles[i]
                h, state, conv = mamba2.apply_mamba2(lp["mamba"], y, cfg, cache.ssm[layer, t],
                                                     cache.conv[layer, t], decode=True)
                cache.ssm[layer, t] = state
                cache.conv[layer, t] = conv
                return h
            return run

        xs = self._run_layers(xs, attend_at, mamba_at, valid=b)
        logits = torch.cat([self._head(x) for x in xs])
        return logits[:b], cache._replace(pos=pos + 1)

    @torch.inference_mode()
    def decode_step_paged(self, tokens: torch.Tensor, k_pools: torch.Tensor,
                          v_pools: torch.Tensor, page_table: torch.Tensor,
                          lens: torch.Tensor):
        """Per-slot decode through a paged KV pool (continuous batching);
        attention-KV families only (ssm and hybrid keep recurrent state
        that has no sequence axis to page).

        tokens: (B, 1) int; k_pools/v_pools: (L, NP, page, K, hd) global
        page pools, written in place; page_table: (B, MP) page ids;
        lens: (B,) per-slot cache lengths, the position each slot's new
        token is written at. Returns (logits (B, 1, V), k_pools, v_pools)."""
        cfg = self.cfg
        if cfg.family not in ATTN_FAMILIES:
            raise ValueError(
                f"decode_step_paged supports dense/moe/vlm families, got "
                f"{cfg.family!r} — use the static engine for ssm/hybrid")
        b = tokens.shape[0]
        rows = decode_rows(b)
        table, lens = _pad_rows(page_table, rows), _pad_rows(lens, rows)
        tiles, xs = self._tiles(tokens, rows)
        index = [attn.paged_index(cfg, table[t], lens[t], k_pools.shape[2]) for t in tiles]

        def attend_at(lp, layer):
            def run(i, y):
                t = tiles[i]
                return attn.attention_decode_paged(lp["attn"], y, cfg, k_pools[layer],
                                                   v_pools[layer], table[t], lens[t],
                                                   index[i])[0]
            return run

        xs = self._run_layers(xs, attend_at, None, valid=b)
        logits = torch.cat([self._head(x) for x in xs])
        return logits[:b], k_pools, v_pools
