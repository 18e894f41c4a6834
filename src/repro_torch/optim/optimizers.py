"""Optimizers written out by hand (torch port of ``repro.optim.optimizers``).

AdamW keeps m/v in float32 (params may be bf16; the update math runs in
float32 and casts back, with no separate master copy), after a global-norm
clip and under a linear warmup, in the reference's order of operations.
``torch.optim.AdamW`` is not used: its schedule and clip order differ.

State and parameters are updated in place (under ``torch.no_grad``), which
saves a full copy of m, v and the parameters per step; the arithmetic is the
reference's, operation for operation.

``update`` takes one of two routes by what it is given. AdamW on the card
runs O1, the two CUDA kernels of ``kernels/adamw.py``: the clip and the
whole update fused over every leaf, the step's scalars derived on the card,
with the eager route's float32 operations (its bits, but for the norm's
order of summation). It takes plain CUDA tensors and the local shards of
DTensors (a step on a ``DeviceMesh``), and refuses, by name, a leaf it
cannot take (``kernels.adamw.local_tree``) rather than run it eagerly.
CPU tensors and ``sgdm`` run the eager route, ``update_eager``, the plain
version.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import adamw


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | sgdm
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9
    grad_clip: float = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    step: int
    m: list
    v: list | None  # None for sgdm


def init(params: Sequence[torch.Tensor], cfg: OptConfig) -> OptState:
    def zeros():
        return [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]

    if cfg.name not in ("adamw", "sgdm"):
        raise ValueError(cfg.name)
    return OptState(step=0, m=zeros(), v=zeros() if cfg.name == "adamw" else None)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def _clip(grads: Sequence[torch.Tensor], max_norm: float):
    total = sum(torch.sum(torch.square(g.to(torch.float32))) for g in grads)
    gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return [g.to(torch.float32) * scale for g in grads], gnorm


@torch.no_grad()
def update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           state: OptState, cfg: OptConfig):
    """Updates ``params`` and the state tensors in place; returns
    (new_state, metrics). AdamW on the card runs O1 (module doc), without a
    host copy or a synchronize; CPU tensors and ``sgdm`` ``update_eager``."""
    if cfg.name == "adamw" and adamw.on_card(params):
        step = state.step + 1
        gnorm, lr = adamw.adamw_step(params, grads, state.m, state.v, step, cfg)
        return OptState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}
    return update_eager(params, grads, state, cfg)


@torch.no_grad()
def update_eager(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                 state: OptState, cfg: OptConfig):
    """``update``'s eager route, on any device: the plain version that O1
    is held to."""
    step = state.step + 1
    step_f = _f32(step, grads[0])
    lr = _schedule(cfg, step_f)
    grads, gnorm = _clip(grads, cfg.grad_clip)
    _apply(params, grads, state, cfg, step_f, lr)
    return OptState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def _apply(params, grads, state: OptState, cfg: OptConfig, step_f: torch.Tensor,
           lr: torch.Tensor) -> None:
    """``update_eager``'s update of ``params`` and the moments, in place,
    from the clipped float32 ``grads``."""
    if cfg.name == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        c1 = 1 - _f32(b1, step_f) ** step_f
        c2 = 1 - _f32(b2, step_f) ** step_f
        for p, m, v, g in zip(params, state.m, state.v, grads):
            m.mul_(b1).add_((1 - b1) * g)             # b1*m + (1-b1)*g
            v.mul_(b2).add_((1 - b2) * g * g)         # b2*v + (1-b2)*g*g
            u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            pf = p.to(torch.float32)
            p.copy_(pf - lr * (u + cfg.weight_decay * pf))
    else:
        for p, m, g in zip(params, state.m, grads):
            m.mul_(cfg.momentum).add_(g)
            p.copy_(p.to(torch.float32) - lr * m)
