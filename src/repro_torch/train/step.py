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

On a mesh (``mesh=``, a ``DeviceMesh`` of ``launch/mesh.py`` whose
parameters ``sharding.rules.distribute`` placed), the step has the
reference's two shapes, chosen by ``cfg.dp_boundary`` and the mesh:

* ``replica``: the replica axes (pod, data) are the aggregation boundary.
  Each rank holds its slice of the batch over them and computes on the
  mesh's other axes ('model'): the parameters enter the forward as
  DTensors on that sub-mesh (their shards, no copy), so tensor parallelism
  is DTensor's, and the replica axes stay manual as in the reference's
  ``shard_map``. The per-replica gradients are then aggregated explicitly
  over the replica group (``mesh["data"]``, or the ``(pod, data)`` pair,
  hierarchically).
* ``pod`` (the MoE giants): only 'pod' is the boundary. The forward runs on
  the (data, model) sub-mesh with the batch sharded over 'data' (FSDP
  shards and the expert bank live there), DTensor's float reductions do
  everything within a pod, and FPISA runs over ``mesh["pod"]`` alone. On a
  mesh without 'pod' there is no boundary left and the step is the plain
  native step, as the reference's is: DTensor reduces everything.

FPISA's blocks are the whole leaf's: K1/K2 cut 256-element rows from the
flattened logical leaf, and the block exponent is a row's. A gradient
shard is aggregated in place only when it is a contiguous run of whole
rows: every placement is Replicate or ``Shard(0)``, dim 0 splits evenly
and each shard holds a multiple of 256 elements (and no ``chunk_elems``).
Any other gradient is first redistributed whole on every rank of the
sub-mesh, aggregated, and cut back to the parameter's shard. Of qwen's 14
leaves at model = m (the 'head' attention mode), only ``embed.tok``
(vocab over 'model', 151936 / m rows of 1024) is aggregated in place; the
stacked attention and MLP weights shard dims 1 or 2 and are gathered:
about 617 MB of bf16 gradients held whole per rank, transiently, beside
their shards. Of arctic's (pod boundary, FSDP over 'data'), ``embed.tok``
(``Shard(1)`` over data) and every stacked leaf are gathered, the whole
bf16 gradient, 954 GB at full size: its full-width training needs the
in-place path extended to such shards (ROADMAP).

The optimizer update runs on the whole mesh's DTensors. On the CPU ZeRO-1
(AdamW's moments sharded over 'data', ``rules.opt_pspecs``) resolves
through DTensor's redistribution, as the reference's runs outside the
``shard_map`` under automatic sharding. On the card AdamW is O1 over the
DTensors' local shards (``kernels/adamw.py``), which refuses ZeRO-1's
moments where 'data' has more than one rank: they lie apart from their
parameters. On a mesh whose compute axes all have size 1 (model = 1),
stacked logical workers, buckets and chunks keep the bits they have
without a mesh.

Every step opens the tracer's ``train.step`` span (``repro_torch.trace``)
with the phases as children: ``train.forward_backward`` (the losses and
gradients, every microbatch or logical worker), the aggregator's own
``agg.allreduce_tree``, and ``train.optimizer`` (``optimizers.update``,
clipping included). None of them waits for the device; the loss's
reduction and the glue between the phases are the step's own time.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch import trace as _trace
from repro_torch.core.agg import AggConfig, Aggregator, world_size
from repro_torch.core.allreduce import _all_gather_rows
from repro_torch.models import zamba2
from repro_torch.optim import optimizers


def split_batch(batch: dict, n: int) -> list:
    """``n`` contiguous equal slices of every entry of ``batch`` along its
    batch axis (the reference's ``reshape(n, b // n, ...)``)."""
    parts = {k: v.reshape(n, -1, *v.shape[1:]) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def replica_axes(mesh, cfg) -> tuple:
    """The mesh axes the step aggregates over explicitly (module doc)."""
    names = mesh.mesh_dim_names
    if cfg.dp_boundary == "pod":
        return ("pod",) if "pod" in names else ()
    return tuple(a for a in ("pod", "data") if a in names)


def make_train_step(model, agg: AggConfig, opt_cfg: optimizers.OptConfig,
                    global_batch: int, group=None, accum_steps: int = 1,
                    logical_workers: int = 0, mesh=None):
    """Returns ``step_fn(opt_state, batch) -> (opt_state, metrics)``, which
    updates the model's parameters in place. ``batch`` is this rank's
    (global_batch / world, ...) slice of the global batch (module doc); with
    ``accum_steps`` > 1 it is cut into that many microbatches.

    ``logical_workers`` > 0 selects logical-worker mode (module doc); it
    requires a non-native aggregation strategy, ``accum_steps == 1``, and a
    group whose size divides W, with W dividing the global batch.

    ``mesh`` (instead of ``group``): train on a ``DeviceMesh`` (module
    doc); ``batch`` is then this rank's ``rules.batch_slice`` of the
    global batch."""
    if mesh is not None:
        if group is not None:
            raise ValueError("pass a mesh or a group, not both")
        if model.cfg.family == zamba2.FAMILY:
            raise zamba2.unsupported("step on a DeviceMesh")
        return _mesh_step(model, mesh, agg, opt_cfg, global_batch, accum_steps,
                          logical_workers)
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
        with _trace.span("train.step"):
            with _trace.span("train.forward_backward"):
                loss, grads = grads_and_loss(batch)
            grads = aggregator.allreduce_tree(dict(zip(names, grads)))
            if agg.strategy == "native" and world > 1:
                grads = {k: g / world for k, g in grads.items()}
            if world > 1:
                for g in reversed(groups):
                    # the reported scalar loss, not a gradient: those went through the Aggregator
                    # repro-lint: disable=torch-bit-identity
                    dist.all_reduce(loss, group=g)
                loss = loss / world
            with _trace.span("train.optimizer"):
                opt_state, metrics = optimizers.update(
                    params, [grads[n] for n in names], opt_state, opt_cfg)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step


def make_serve_steps(model, mesh=None):
    """``(prefill, decode)``: ``prefill(batch, cache)`` and ``decode(tokens,
    cache)`` over the model's ``prefill`` and ``decode_step`` methods, the
    reference's pair without its ``params`` argument (the port's model holds
    its parameters). ``batch`` is the reference's dict: ``tokens``, and
    ``patch_embeds`` for vlm or ``frames`` for the encoder-decoder. The
    reference's pair are plain auto-sharded jits that do not read ``mesh``;
    the port has no jit to wrap, and a model that ``sharding.rules.
    distribute`` placed carries its placements into the calls, so ``mesh``
    is accepted for the same signature and not read either."""

    def prefill(batch: dict, cache):
        return model.prefill(batch["tokens"], cache,
                             batch.get("frames", batch.get("patch_embeds")))

    def decode(tokens: torch.Tensor, cache):
        return model.decode_step(tokens, cache)

    return prefill, decode


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
        with _trace.span("train.step"):
            with _trace.span("train.forward_backward"):
                losses, stacks = _worker_grads(model, params, batch, k)
            grads = aggregator.allreduce_tree(dict(zip(names, stacks)))
            del stacks
            loss = _fold_losses(losses, group, workers)
            with _trace.span("train.optimizer"):
                opt_state, metrics = optimizers.update(
                    params, [grads[n] for n in names], opt_state, opt_cfg)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step


def _worker_grads(model, params, batch: dict, k: int):
    """(losses (k,), per-leaf (k, ...) gradients) of k workers, each owning
    an equal contiguous slice of ``batch``. Each worker's gradients go
    straight into its row of a preallocated buffer: no stacked copy of k
    gradient trees."""
    stacks = [torch.empty((k, *p.shape), dtype=p.dtype, device=p.device) for p in params]
    losses = torch.empty(k, dtype=torch.float32, device=params[0].device)
    for j, mb in enumerate(split_batch(batch, k)):
        loss = model.loss(mb)
        for stack, g in zip(stacks, torch.autograd.grad(loss, params)):
            stack[j].copy_(g)
        losses[j] = loss.detach()
    return losses, stacks


def _fold_losses(losses: torch.Tensor, group, workers: int) -> torch.Tensor:
    """The fixed-order loss: the gathered (W,) vector has the same order on
    every group; fold it left to right in float32, one add at a time
    (torch.sum is a tree reduction whose grouping is not fixed)."""
    loss = torch.zeros((), dtype=torch.float32, device=losses.device)
    for v in _all_gather_rows(losses, group).reshape(-1):
        loss = loss + v
    return loss / workers


# ---------------------------------------------------------------------------
# the step on a mesh
# ---------------------------------------------------------------------------


def _in_place(view, agg: AggConfig) -> bool:
    """Whether every shard of ``view`` (a DTensor) is a contiguous run of
    whole aggregation rows of the flattened leaf (module doc)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, pls = view.device_mesh, view.placements
    if agg.chunk_elems or not all(isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim == 0)
                                  for p in pls):
        return False
    parts = math.prod(mesh.size(i) for i, p in enumerate(pls) if isinstance(p, Shard))
    return view.shape[0] % parts == 0 and (view.numel() // parts) % agg.block == 0


@contextlib.contextmanager
def _swapped(model, views: dict):
    """The model's parameters replaced by ``views`` inside the block."""
    from repro_torch.sharding.rules import set_param

    held = dict(model.named_parameters())
    for name, v in views.items():
        set_param(model, name, v)
    try:
        yield
    finally:
        for name, p in held.items():
            set_param(model, name, p)


class MeshGrads:
    """How a step on ``mesh`` turns a model's gradients into aggregated
    ones (module doc): ``views()`` gives the parameters as the forward
    sees them (DTensors on the compute sub-mesh, or plain tensors),
    ``local(g, view)`` a gradient as the aggregator takes it, and
    ``aggregate(locals, targets, views)`` the aggregated gradients as
    DTensors placed like the parameters on the whole mesh."""

    def __init__(self, model, mesh, agg: AggConfig, *, stacked: bool = False):
        from torch.distributed.tensor import DTensor, Shard

        self.model, self.mesh, self.agg = model, mesh, agg
        names = mesh.mesh_dim_names
        self.boundary = replica_axes(mesh, model.cfg)
        compute = tuple(a for a in names if a not in self.boundary)
        self.cmesh = mesh[compute] if compute else None
        self.on_compute = [i for i, a in enumerate(names) if a in compute]
        self.replicas = math.prod(mesh.size(names.index(a)) for a in self.boundary)
        self.groups = tuple(mesh[a].get_group() for a in self.boundary)
        for name, p in model.named_parameters():
            if not isinstance(p, DTensor) or p.device_mesh != mesh:
                raise ValueError(f"parameter {name} is not placed on the mesh; "
                                 f"call sharding.rules.distribute first")
            if any(isinstance(p.placements[names.index(a)], Shard) for a in self.boundary):
                raise ValueError(f"parameter {name} is sharded over the replica axes "
                                 f"{self.boundary}")
        # logical workers compute on plain whole tensors (compute axes of size 1)
        self.local_compute = self.cmesh is None or stacked
        self.aggregator = (Aggregator(agg, self.groups, stacked=stacked) if self.boundary
                           else None)

    def views(self) -> dict:
        from torch.distributed.tensor import DTensor

        out = {}
        for name, p in self.model.named_parameters():
            local = p.to_local().detach()
            if not self.local_compute:
                local = DTensor.from_local(
                    local, self.cmesh, [p.placements[i] for i in self.on_compute],
                    run_check=False, shape=p.shape, stride=p.stride())
            out[name] = torch.nn.Parameter(local)
        return out

    def local(self, g, view):
        """(local tensor, its placements on the compute mesh or None)."""
        from torch.distributed.tensor import DTensor, Replicate

        if not isinstance(g, DTensor):
            return g, None
        target = (tuple(view.placements) if _in_place(view, self.agg)
                  else (Replicate(),) * self.cmesh.ndim)
        return g.redistribute(self.cmesh, target).to_local(), target

    def aggregate(self, local: list, targets: list, views: dict) -> list:
        from torch.distributed.tensor import DTensor

        if self.aggregator is not None:
            local = list(self.aggregator.allreduce_tree(dict(zip(views, local))).values())
            if self.agg.strategy == "native":
                local = [g / self.replicas for g in local]
        out = []
        for (_, p), view, g, target in zip(self.model.named_parameters(), views.values(),
                                            local, targets):
            if target is not None:
                g = DTensor.from_local(g, self.cmesh, target, run_check=False, shape=p.shape,
                                       stride=p.stride())
                g = g.redistribute(self.cmesh, view.placements).to_local()
            out.append(DTensor.from_local(g, self.mesh, p.placements, run_check=False,
                                          shape=p.shape, stride=p.stride()))
        return out


def _mesh_step(model, mesh, agg: AggConfig, opt_cfg: optimizers.OptConfig,
               global_batch: int, accum_steps: int, logical_workers: int):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.sharding import hints, rules

    plan = MeshGrads(model, mesh, agg, stacked=bool(logical_workers))
    boundary, replicas, groups = plan.boundary, plan.replicas, plan.groups
    names = mesh.mesh_dim_names
    bax = rules.batch_axes(mesh, global_batch)
    local_rows = global_batch // math.prod(mesh.size(names.index(a)) for a in bax)
    if logical_workers:
        if agg.strategy == "native" or not boundary:
            raise ValueError(
                "logical_workers needs an explicit aggregation boundary with "
                f"a non-native strategy (got strategy={agg.strategy!r}, "
                f"boundary={boundary})")
        if accum_steps != 1:
            raise ValueError("logical_workers is incompatible with accum_steps")
        if logical_workers % replicas or global_batch % logical_workers:
            raise ValueError(
                f"logical_workers={logical_workers} must be a multiple of the "
                f"replica extent {replicas} and divide global_batch={global_batch}")
        if plan.cmesh is not None and plan.cmesh.size() != 1:
            raise ValueError("logical_workers on a mesh needs compute axes of size 1")
    if accum_steps < 1 or local_rows % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} must divide the per-rank batch "
                         f"{local_rows}")
    compute = [a for a in names if a not in boundary]
    batch_pl = tuple(Shard(0) if a in bax else Replicate() for a in compute)

    def wrap_batch(batch: dict) -> dict:
        if plan.local_compute:
            return batch
        return {k: DTensor.from_local(v, plan.cmesh, batch_pl, run_check=False)
                for k, v in batch.items()}

    def grads(v: dict, batch: dict):
        params = list(v.values())
        if logical_workers:
            losses, stacks = _worker_grads(model, params, batch, logical_workers // replicas)
            return losses, stacks, [None] * len(params)
        acc = targets = None
        loss_acc = 0.0
        for mb in split_batch(batch, accum_steps):
            loss = model.loss(wrap_batch(mb))
            pairs = [plan.local(g, p)
                     for g, p in zip(torch.autograd.grad(loss, params), params)]
            loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
            targets = [t for _, t in pairs]
            if accum_steps == 1:
                return loss.detach(), [g for g, _ in pairs], targets
            if acc is None:
                acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                       for g, _ in pairs]
            for a, (g, _) in zip(acc, pairs):
                a += g.to(torch.float32)
            loss_acc = loss_acc + loss.detach()
        inv = 1.0 / accum_steps
        return loss_acc * inv, [a * inv for a in acc], targets

    def train_step(opt_state: optimizers.OptState, batch: dict):
        with _trace.span("train.step"):
            v = plan.views()
            with _trace.span("train.forward_backward"), _swapped(model, v), \
                    hints.use_mesh(mesh), implicit_replication():
                loss, local, targets = grads(v, batch)
            full = plan.aggregate(local, targets, v)
            if logical_workers:
                loss = _fold_losses(loss, groups[0] if len(groups) == 1 else groups,
                                    logical_workers)
            elif boundary:
                for g in reversed(groups):
                    # the reported scalar loss, not a gradient: those went through the Aggregator
                    # repro-lint: disable=torch-bit-identity
                    dist.all_reduce(loss, group=g)
                loss = loss / replicas
            params = [p for _, p in model.named_parameters()]
            with _trace.span("train.optimizer"), implicit_replication():
                opt_state, metrics = optimizers.update(params, full, opt_state, opt_cfg)
        metrics = {k: (m.full_tensor() if isinstance(m, DTensor) else m)
                   for k, m in metrics.items()}
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step
