"""Train-step factory: FPISA gradient aggregation at the data-parallel
boundary (torch port of the ``replica`` path of ``repro.train.step``).

Every rank holds the full parameters and computes the gradients of the mean
loss over its slice of the global batch. The per-rank gradients are then
aggregated explicitly by the configured strategy, one leaf at a time
(``Aggregator.allreduce_tree``): the paper's architecture, in which workers
compute full gradients and the FPISA collective aggregates them. The
integer strategies SUM the gradients over ranks, as the reference's
``lax.psum`` does; ``native`` takes the gradient of the global-batch mean,
as the reference's auto-sharded native step does. The reported loss is the
mean over ranks. DDP is not used: the aggregation IS the collective.

Not ported yet: the ``pod`` boundary, ``accum_steps`` > 1, logical workers
(elastic mode) and bucketing.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.agg import AggConfig, Aggregator, world_size
from repro_torch.optim import optimizers


def make_train_step(model, agg: AggConfig, opt_cfg: optimizers.OptConfig,
                    global_batch: int, group=None):
    """Returns ``step_fn(opt_state, tokens) -> (opt_state, metrics)``, which
    updates the model's parameters in place. ``tokens`` is this rank's
    (global_batch / world, S) slice of the global batch."""
    world = world_size(group)
    if global_batch % world:
        raise ValueError(f"global_batch={global_batch} is not divisible by the "
                         f"{world} ranks of the data-parallel group")
    # the ONE facade instance for this step: validation happens here
    aggregator = Aggregator(agg, group)
    names, params = zip(*model.named_parameters())

    def train_step(opt_state: optimizers.OptState, tokens: torch.Tensor):
        loss = model.loss(tokens)
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        grads = aggregator.allreduce_tree(grads)
        if agg.strategy == "native" and world > 1:
            grads = {k: g / world for k, g in grads.items()}
        loss = loss.detach()
        if world > 1:
            dist.all_reduce(loss, group=group)
            loss = loss / world
        opt_state, metrics = optimizers.update(
            params, [grads[n] for n in names], opt_state, opt_cfg)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step
