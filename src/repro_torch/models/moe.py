"""Top-k Mixture-of-Experts with grouped, capacity-bounded index dispatch
(torch port of ``repro.models.moe``).

Tokens are routed within groups of ``moe_group_size`` tokens of the whole
``B * S`` batch (halved until the group divides it); each expert takes at
most ``capacity`` (token, slot) pairs of a group, in token order. Dispatch
and combine are gathers, as in the reference; the three expert products
are batched products over the (group, expert) buffers.

Copied on purpose (F10): the reference scatters every dropped (token,
slot) pair to slot ``capacity - 1`` of its expert with the sentinel token
(a zero row), after the kept pairs (XLA-CPU's serial scatter order). So an
expert that receives more than ``capacity`` pairs keeps only
``capacity - 1`` tokens, and the pair of rank ``capacity - 1`` gets a zero
output. The port computes that slot explicitly from the per-expert counts
(a scatter with duplicate indices has no defined winner on CUDA), so the
CPU and the card give the reference's result.

Ties. ``jax.lax.top_k`` returns the lower expert index first among equal
probabilities; ``torch.topk`` promises no order, so the port takes the
first ``k`` of a stable descending sort.

Overflows. Under ``torch.inference_mode()`` (serving) each call adds the
number of (group, expert) queues that ran past capacity to
:data:`OVERFLOWS`, on the device (no synchronization): a serving run with
none has results that do not depend on how its rows were batched together
beyond the grouping itself.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.layers import dtype_of, param, silu
from repro_torch.sharding.hints import constrain


def init_moe(gen: torch.Generator, cfg, lead=()) -> dict:
    """Router float32 (d, E); ``wg``/``wi`` (E, d, f), ``wo`` (E, f, d) in
    the parameter dtype; sorted keys."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = dtype_of(cfg.param_dtype)
    return {
        "router": param(gen, (*lead, d, e), torch.float32),
        "wg": param(gen, (*lead, e, d, f), dt),
        "wi": param(gen, (*lead, e, d, f), dt),
        "wo": param(gen, (*lead, e, f, d), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }


def _capacity(cfg, group_tokens: int) -> int:
    c = int(math.ceil(group_tokens * cfg.num_experts_per_token * cfg.capacity_factor
                      / cfg.num_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def group_size(cfg, tokens: int) -> int:
    """Tokens per dispatch group: ``moe_group_size``, at most ``tokens``,
    halved until it divides ``tokens``."""
    tg = min(cfg.moe_group_size, tokens)
    while tokens % tg:
        tg //= 2
    return tg


class Routing(NamedTuple):
    gates: torch.Tensor     # (ng, tg, k) float32, renormalized
    experts: torch.Tensor   # (ng, tg, k) int64, ties to the lower index
    pos: torch.Tensor       # (ng, tg * k) rank of each (token, slot) in its expert's queue
    keep: torch.Tensor      # (ng, tg * k) bool, pos < capacity
    slot_tok: torch.Tensor  # (ng, E, capacity) token per slot; tg = the zero row
    overflow: torch.Tensor  # (ng, E) bool, the queue ran past capacity
    aux: torch.Tensor       # () float32 load-balance loss


class _Overflows:
    """Overflowed (group, expert) queues summed over serving calls, kept on
    the device; ``read()`` returns the count and restarts it."""

    def __init__(self):
        self.total = None

    def add(self, n: torch.Tensor) -> None:
        self.total = n if self.total is None else self.total + n

    def read(self) -> int:
        n = 0 if self.total is None else int(self.total)
        self.total = None
        return n


OVERFLOWS = _Overflows()


def _count(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(idx, minlength=n)`` for indices below ``n``, with an
    output shape that does not depend on the values (the dry run traces
    with fake tensors, which have none)."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def route(p: dict, xg: torch.Tensor, cfg) -> Routing:
    """Router, top-k, aux loss and the (group, expert, capacity) slot table
    of grouped tokens ``xg`` (ng, tg, d)."""
    ng, tg, _ = xg.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    cap = _capacity(cfg, tg)
    # float32 logits of the compute-dtype product (preferred_element_type)
    logits = xg.to(torch.float32) @ p["router"].to(xg.dtype).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = order.values[..., :k], order.indices[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance auxiliary loss (Switch Transformer style)
    me = probs.mean(dim=(0, 1))
    ce = _count(eidx.reshape(-1), e).to(torch.float32) / (ng * tg * k)
    aux = e * torch.sum(me * ce)

    # rank of each (token, slot) in its expert's queue: stable sort, then
    # the distance to the start of its run
    flat = eidx.reshape(ng, tg * k)
    tgk = tg * k
    sort_idx = torch.sort(flat, dim=1, stable=True).indices
    sorted_e = flat.gather(1, sort_idx)
    ar = torch.arange(tgk, device=xg.device).expand(ng, tgk)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, ar, 0), dim=1).values
    pos = torch.empty_like(flat).scatter_(1, sort_idx, ar - seg_start)
    keep = pos < cap

    # slot table: each kept pair's slot is unique; dropped pairs go to a
    # spare column that is cut off
    tok_ids = torch.arange(tg, device=xg.device).repeat_interleave(k).expand(ng, tgk)
    table = torch.full((ng, e * cap + 1), tg, dtype=torch.int64, device=xg.device)
    table.scatter_(1, torch.where(keep, flat * cap + pos, e * cap), tok_ids)
    slot_tok = table[:, :e * cap].reshape(ng, e, cap)
    # F10: an overflowing expert's slot cap - 1 holds the sentinel (module doc)
    groups = torch.arange(ng, device=xg.device)[:, None] * e
    counts = _count((groups + flat).reshape(-1), ng * e).reshape(ng, e)
    overflow = counts > cap
    slot_tok[..., cap - 1] = torch.where(overflow, tg, slot_tok[..., cap - 1])
    return Routing(gates, eidx, pos, keep, slot_tok, overflow, aux)


def apply_moe(p: dict, x: torch.Tensor, cfg):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar float32). A DTensor
    ``x`` (a step on a mesh) goes through ``_apply_moe_sharded``."""
    if hasattr(x, "device_mesh"):
        return _apply_moe_sharded(p, x, cfg)
    return _apply_moe(p, x, cfg, p["wi"], p["wg"], p["wo"], 0)


def _apply_moe_sharded(p: dict, x, cfg):
    """Expert parallelism on the DTensors of a mesh step. The tokens of the
    compute mesh and the router are gathered whole on every rank, which
    routes them all (routing is cheap and its sorts and scatters have no
    DTensor rules); each rank then runs only its shard of the expert bank
    (experts over 'model', expert ff over 'data', ``sharding/rules.py``),
    so its output is a partial sum over the mesh dimensions that split the
    bank, and DTensor reduces it into ``x``'s layout. The gradients the
    local region sends back to the gathered tokens and router are partial
    sums over those dimensions too, so the aux loss, which every rank
    computes whole, enters divided by their size (a power of two here, so
    exactly)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.sharding.rules import local_range

    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    wi = p["wi"]
    # mesh dims that split the bank: Shard(0) (experts) or Shard(2) (ff)
    split = [isinstance(pl, Shard) and pl.dim in (0, 2) for pl in wi.placements]
    grad_pl = [Partial() if sp else Replicate() for sp in split]
    parts = math.prod(mesh.size(i) for i, sp in enumerate(split) if sp)
    xl = x.redistribute(mesh, rep).to_local(grad_placements=grad_pl)
    router = p["router"].redistribute(mesh, rep).to_local(grad_placements=grad_pl)
    e0, _ = local_range(wi.shape[0], mesh, wi.placements, 0, wi.ndim)
    out, aux = _apply_moe({"router": router}, xl, cfg, wi.to_local(), p["wg"].to_local(),
                          p["wo"].to_local(), e0)
    out = DTensor.from_local(out, mesh, grad_pl, run_check=False)
    aux = DTensor.from_local(aux / parts, mesh, grad_pl, run_check=False)
    return out.redistribute(mesh, x.placements), aux.redistribute(mesh, rep)


def _apply_moe(p: dict, x: torch.Tensor, cfg, wi, wg, wo, e0: int):
    """The expert layer with the bank's experts [e0, e0 + wi.shape[0]) (the
    whole bank, or a rank's shard)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    tg = group_size(cfg, b * s)
    ng = b * s // tg
    xg = x.reshape(ng, tg, d)
    r = route(p, xg, cfg)
    cap = r.slot_tok.shape[-1]
    if torch.is_inference_mode_enabled():
        OVERFLOWS.add(r.overflow.sum())

    # gather tokens into expert buffers (row tg of the padded group: zeros)
    # Sharding: token groups follow the batch axes, experts ride 'model'
    xg_pad = constrain(torch.cat([xg, xg.new_zeros((ng, 1, d))], dim=1), "batch", None, None)
    slot_tok = constrain(r.slot_tok, "batch", "model", None)
    groups = torch.arange(ng, device=x.device)[:, None, None]
    buf = constrain(xg_pad[groups, slot_tok], "batch", "model", None, None)  # (ng, E, cap, d)

    # expert FFN (swiglu), one batched product per expert weight
    el = wi.shape[0]
    if el != e:  # a shard of the bank: the others' outputs are zero here
        buf = buf[:, e0:e0 + el]
    h = torch.einsum("gecd,edf->gecf", buf, wi)
    hg = silu(torch.einsum("gecd,edf->gecf", buf, wg))
    eout = torch.einsum("gecf,efd->gecd", h * hg, wo)          # (ng, E, cap, d)
    if el != e:
        eout = torch.cat([eout.new_zeros((ng, e0, cap, d)), eout,
                          eout.new_zeros((ng, e - e0 - el, cap, d))], dim=1)
    eout = constrain(eout, "batch", "model", None, None)

    # combine: each (token, slot)'s expert output, gate-weighted
    src = r.experts.reshape(ng, tg * k) * cap + torch.where(r.keep, r.pos, 0)
    eflat = constrain(eout.reshape(ng, e * cap, d), "batch", None, None)
    picked = eflat.gather(1, src[..., None].expand(-1, -1, d))
    picked = torch.where(r.keep[..., None], picked, 0.0).reshape(ng, tg, k, d)
    out = torch.einsum("gtk,gtkd->gtd", r.gates.to(picked.dtype), picked)
    return out.reshape(b, s, d), r.aux
