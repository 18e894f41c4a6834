"""Train-step factory: FPISA gradient aggregation at the data-parallel
boundary (torch port of the ``replica`` path of ``repro.train.step``).

Every rank holds the full parameters and computes the gradients of the mean
loss over its slice of the global batch. The per-rank gradients are then
aggregated explicitly by the configured strategy
(``Aggregator.allreduce_tree``): per leaf, or, with ``agg.bucket_bytes``
set, streamed through fixed-size block-aligned wire buckets with
double-buffered dispatch (core/bucketer.py), bit-identical to per leaf. This
is the paper's architecture, in which workers compute full gradients and the
FPISA collective aggregates them. The integer strategies SUM the gradients
over ranks, as the reference's ``lax.psum`` does; ``native`` takes the
gradient of the global-batch mean, as the reference's auto-sharded native
step does. The reported loss is the mean over ranks. DDP is not used: the
aggregation IS the collective. ``group`` may be a ``(pod_group,
data_group)`` pair (``runtime/elastic.py::make_groups``), which the
Aggregator reduces hierarchically.

A batch is a dict of tensors with a leading batch axis, as the reference's:
``tokens`` (B, S) and, for vlm, ``patch_embeds`` (B, P, d). The loss is
``model.loss(batch)`` (the moe family's includes its aux term).
``accum_steps`` > 1 splits this rank's batch into microbatches and
accumulates their gradients in float32, as the reference's scan does; the
split (and the logical workers' below) cuts every entry of the batch into
the reference's contiguous slices, so an MoE layer groups its tokens as
the reference's does.

Logical-worker mode (``logical_workers`` = W > 0) decouples the aggregation
from the group for elastic fault tolerance: the global batch is owned by W
fixed logical workers (= switch ports); each rank hosts k = W / world of
them, computes their gradients SEPARATELY, one after another, into (k, ...)
buffers, and aggregates through the stacked integer-domain collectives
(core/allreduce.py, stacked section). The wire shift is derived from W and
integer addition is associative, so the aggregated gradient, and the loss
folded left to right in float32 over the gathered (W,) per-worker losses,
are bit-identical on any group that divides W. That is what lets
runtime/controller.py resume on the survivors of a host death with a
trajectory equal, bit for bit, to the uninterrupted run.

Not ported yet: the ``pod`` boundary.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.agg import AggConfig, Aggregator, world_size
from repro_torch.core.allreduce import _all_gather_rows
from repro_torch.optim import optimizers


def split_batch(batch: dict, n: int) -> list:
    """``n`` contiguous equal slices of every entry of ``batch`` along its
    batch axis (the reference's ``reshape(n, b // n, ...)``)."""
    parts = {k: v.reshape(n, -1, *v.shape[1:]) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(model, agg: AggConfig, opt_cfg: optimizers.OptConfig,
                    global_batch: int, group=None, accum_steps: int = 1,
                    logical_workers: int = 0):
    """Returns ``step_fn(opt_state, batch) -> (opt_state, metrics)``, which
    updates the model's parameters in place. ``batch`` is this rank's
    (global_batch / world, ...) slice of the global batch (module doc); with
    ``accum_steps`` > 1 it is cut into that many microbatches.

    ``logical_workers`` > 0 selects logical-worker mode (module doc); it
    requires a non-native aggregation strategy, ``accum_steps == 1``, and a
    group whose size divides W, with W dividing the global batch."""
    world = world_size(group)
    if logical_workers:
        if agg.strategy == "native":
            raise ValueError(
                "logical_workers needs an explicit aggregation boundary with "
                f"a non-native strategy (got strategy={agg.strategy!r}, "
                f"group of {world} ranks)")
        if accum_steps != 1:
            raise ValueError("logical_workers is incompatible with accum_steps")
        if logical_workers % world or global_batch % logical_workers:
            raise ValueError(
                f"logical_workers={logical_workers} must be a multiple of the "
                f"replica extent {world} and divide global_batch={global_batch}")
        return _logical_worker_step(model, agg, opt_cfg, group, logical_workers)
    if global_batch % world:
        raise ValueError(f"global_batch={global_batch} is not divisible by the "
                         f"{world} ranks of the data-parallel group")
    if accum_steps < 1 or (global_batch // world) % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} must divide the per-rank batch "
                         f"{global_batch // world}")
    # the ONE facade instance for this step: validation happens here
    aggregator = Aggregator(agg, group)
    names, params = zip(*model.named_parameters())
    groups = group if isinstance(group, tuple) else (group,)

    def grads_and_loss(batch):
        if accum_steps == 1:
            loss = model.loss(batch)
            return loss.detach(), torch.autograd.grad(loss, params)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
        loss_acc = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for mb in split_batch(batch, accum_steps):
            loss = model.loss(mb)
            for a, g in zip(acc, torch.autograd.grad(loss, params)):
                a += g.to(torch.float32)
            loss_acc = loss_acc + loss.detach()
        inv = 1.0 / accum_steps
        return loss_acc * inv, [a * inv for a in acc]

    def train_step(opt_state: optimizers.OptState, batch: dict):
        loss, grads = grads_and_loss(batch)
        grads = aggregator.allreduce_tree(dict(zip(names, grads)))
        if agg.strategy == "native" and world > 1:
            grads = {k: g / world for k, g in grads.items()}
        if world > 1:
            for g in reversed(groups):
                dist.all_reduce(loss, group=g)
            loss = loss / world
        opt_state, metrics = optimizers.update(
            params, [grads[n] for n in names], opt_state, opt_cfg)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step


def _logical_worker_step(model, agg: AggConfig, opt_cfg: optimizers.OptConfig, group,
                         workers: int):
    """The logical-worker step: this rank hosts k = W / world contiguous
    workers (rank d hosts [d*k, (d+1)*k), the order of the stacked
    all-gather), each owning an equal contiguous slice of the rank's
    tokens."""
    k = workers // world_size(group)
    aggregator = Aggregator(agg, group, stacked=True)
    names, params = zip(*model.named_parameters())

    def train_step(opt_state: optimizers.OptState, batch: dict):
        # each worker's gradients go straight into its row of a preallocated
        # (k, ...) buffer: no stacked copy of k gradient trees
        stacks = [torch.empty((k, *p.shape), dtype=p.dtype, device=p.device) for p in params]
        dev = params[0].device
        losses = torch.empty(k, dtype=torch.float32, device=dev)
        for j, mb in enumerate(split_batch(batch, k)):
            loss = model.loss(mb)
            for stack, g in zip(stacks, torch.autograd.grad(loss, params)):
                stack[j].copy_(g)
            losses[j] = loss.detach()
        grads = aggregator.allreduce_tree(dict(zip(names, stacks)))
        del stacks
        # fixed-order loss: the gathered (W,) vector has the same order on
        # every group; fold it left to right in float32, one add at a time
        # (torch.sum is a tree reduction whose grouping is not fixed)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for v in _all_gather_rows(losses, group).reshape(-1):
            loss = loss + v
        opt_state, metrics = optimizers.update(
            params, [grads[n] for n in names], opt_state, opt_cfg)
        metrics["loss"] = loss / workers
        return opt_state, metrics

    return train_step
