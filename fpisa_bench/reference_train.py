"""The plain reference of a training step, followed for a cell's first
steps: the configuration's loss and its gradients (``autograd.grad``),
the FPISA aggregation of one worker (``fpisa_ref``), and AdamW with a
global-norm clip under a linear warm-up, the parameters stored in the
configuration's dtype after each update.

The update is written from the optimizer's settings in the traffic file
(the same numbers the program is given): m and v in float32, bias-
corrected, decoupled weight decay, learning rate ``lr * min((t + 1) /
warmup_steps, 1)`` at update t = 1, 2, ... Imports nothing of the program.
"""
from __future__ import annotations

import torch

from fpisa_bench import fpisa_ref


def adamw_step(params: dict, grads: dict, m: dict, v: dict, t: int, opt: dict, store):
    """One update of the float32 ``params`` in place (stored through
    ``store``, the rounding to the parameter dtype)."""
    total = sum(g.square().sum() for g in grads.values())
    scale = torch.clamp(opt["grad_clip"] / torch.clamp(total.sqrt(), min=1e-9), max=1.0)
    lr = opt["lr"] * min((t + 1) / max(opt["warmup_steps"], 1), 1.0)
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    for n, p in params.items():
        g = grads[n] * scale
        m[n].mul_(b1).add_((1 - b1) * g)
        v[n].mul_(b2).add_((1 - b2) * g * g)
        u = (m[n] / c1) / ((v[n] / c2).sqrt() + opt["eps"])
        p.copy_(store(p - lr * (u + opt["weight_decay"] * p)))


def follow(model, cfg: dict, weights: dict, batches: list, opt: dict, param_dtype,
           mm=torch.matmul) -> dict:
    """Train from ``weights`` (leaf name -> tensor) on ``batches`` (token
    tensors), one step each, and read what the benchmark compares:
    ``losses`` (one a step), ``grad`` (each leaf's norm of the first
    aggregated gradient as the optimizer takes it in, m / (1 - b1) after
    one step), ``agg_grad`` (each leaf's norm of that gradient before the
    clip), ``change`` (each leaf's norm of the parameters' change over all
    the steps)."""
    def store(x):
        return x.to(param_dtype).to(torch.float32)

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False

    params = {n: w.to(torch.float32) for n, w in weights.items()}
    start = {n: p.clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    out = {"losses": []}
    for t, tokens in enumerate(batches, start=1):
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        loss = model.loss(leaves, tokens, cfg, mm)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        del leaves
        agg = {n: fpisa_ref.aggregate(g[None]) for n, g in zip(params, grads)}
        del grads
        out["losses"].append(float(loss.detach()))
        if t == 1:
            out["agg_grad"] = {n: float(g.norm()) for n, g in agg.items()}
        adamw_step(params, agg, m, v, t, opt, store)
        if t == 1:
            out["grad"] = {n: float(mi.norm()) / (1 - opt["b1"]) for n, mi in m.items()}
        del agg
    out["change"] = {n: float((params[n] - start[n]).norm()) for n in params}
    return out
