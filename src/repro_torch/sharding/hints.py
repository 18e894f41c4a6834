"""In-model sharding constraints that are the identity without a mesh (torch
port of ``repro.sharding.hints``).

Model code calls ``constrain(x, *axes)`` with logical placements. A launcher
makes a mesh active with ``use_mesh(mesh)`` (the reference's
``jax.sharding.set_mesh``); then a DTensor ``x`` is redistributed to the
placements, using only the axes that ``x``'s own mesh has. A step computes
on the mesh's non-replica axes (``train/step.py``: the replica axes are
manual there, as in the reference's ``shard_map``), so those are the axes a
constraint sees, as the reference's sees only the auto axes. Without an
active mesh, or for a plain tensor, ``constrain`` returns ``x`` itself, so
single-device runs, tests and examples are unaffected.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_MESH = contextvars.ContextVar("repro_torch_active_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def active_mesh():
    return _MESH.get()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def batch_axes(names) -> tuple:
    return tuple(a for a in ("pod", "data") if a in names)


def constrain(x: torch.Tensor, *placements) -> torch.Tensor:
    """placements: per-dim placement; each is None, an axis name, 'batch'
    (the replica axes present), or a tuple of axis names. Axes not on
    ``x``'s mesh are dropped; without an active mesh, or for a tensor that
    is not a DTensor, this is the identity."""
    if active_mesh() is None or not is_dtensor(x):
        return x
    from repro_torch.sharding.rules import placements as to_placements

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    spec = []
    for pl in placements:
        if pl == "batch":
            pl = batch_axes(names) or None
        if isinstance(pl, tuple):
            pl = tuple(a for a in pl if a in names) or None
        spec.append(pl if pl is None or isinstance(pl, tuple) or pl in names else None)
    want = to_placements(tuple(spec), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def entering(x: torch.Tensor) -> torch.Tensor:
    """The input of a tensor-parallel block (Megatron's f): the identity
    forward, and in the backward the gradient, a partial sum over the
    ranks whose column-split products read ``x``, is reduced into ``x``'s
    own layout at once. Left partial, it would flow into the residual
    stream and make DTensor gather the previous block's row-split weight
    whole. The identity without an active mesh or for a plain tensor."""
    if active_mesh() is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def local_product(x, w, split_dim: int):
    """``x @ w`` for DTensors on each rank's local tensors, for a weight
    split (if at all) along its output dimension ``split_dim`` only: the
    input keeps its batch split (dim 0) and is gathered otherwise, the
    weight keeps its ``split_dim`` split and is gathered otherwise (an FSDP
    split). The output is split like the input's rows and the weight's
    columns (its last dimension); the input's gradient is a partial sum
    over the mesh dimensions that split the weight, the weight's over those
    that split the batch. DTensor's own product could split the output's
    rows over a column axis (a strided shard it cannot gather without
    reading values) or split merged columns across a head."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def on(p, dim):
        return getattr(p, "dim", None) == dim

    mesh = w.device_mesh
    w = w.redistribute(mesh, [p if on(p, split_dim) else Replicate() for p in w.placements])
    x = x.redistribute(mesh, [p if on(p, 0) else Replicate() for p in x.placements])
    pairs = list(zip(w.placements, x.placements))
    xl = x.to_local(grad_placements=[Partial() if on(wp, split_dim) else xp for wp, xp in pairs])
    wl = w.to_local(grad_placements=[Partial() if on(xp, 0) else wp for wp, xp in pairs])
    y = xl @ wl.reshape(wl.shape[0], -1)
    return DTensor.from_local(y, mesh, [Shard(y.ndim - 1) if on(wp, split_dim) else xp
                                        for wp, xp in pairs], run_check=False)
