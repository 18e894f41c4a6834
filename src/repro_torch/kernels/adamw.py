"""Hopper kernels O1: AdamW's global-norm clip and update over a whole
parameter tree, two launches a step.

The reference's ``repro.optim.optimizers`` is plain ``jnp`` (no Pallas
kernel). Its port's plain version is ``optim/optimizers.py::update_eager``
(``_clip``, ``_schedule`` and the AdamW loop), the route of CPU tensors
and ``sgdm``. O1 is AdamW's route on the card
(``csrc/adamw.cu``, whose header says what bounds it and how the design
answers it):

  adamw_norm   : one launch a group of leaves. Every gradient read once in
                 its own dtype, squared in float32, summed into one float64
                 partial a CTA (``NORM_CTAS`` a group), no atomics.
  adamw_update : one launch a group, after every group's norm. Each CTA
                 finishes the norm from all partials in one fixed order,
                 derives the clip's scale, lr and the bias corrections from
                 the integer step with the eager route's float32 operations,
                 and updates m, v and p in place with the eager update's
                 operations, each rounded as the eager kernels round it.

A group is up to ``MAX_LEAVES`` leaves, whose pointers and sizes go to the
kernels by value in their parameters: a step copies nothing from the host
and does not synchronize. With the same clip scale the update writes the
eager route's bits; the norm's order of summation is O1's own, so with the
clip active ``grad_norm`` (and through the scale the update) can differ from
the eager route's in the last bits.

``adamw_step`` runs O1 over a tree of plain CUDA tensors, or over the
local shards of a tree of DTensors (a step on a ``DeviceMesh``), the norm's
partials summed over the mesh between the two launches; ``local_tree``
says what it takes and refuses the rest by name. ``adamw_norm.launches``
and ``adamw_update.launches`` count the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fpisa_fused import raise_on

MAX_LEAVES = 64   # csrc/adamw.cu's kMaxLeaves: the leaves of one launch's table
NORM_CTAS = 1024  # csrc/adamw.cu's kNormCtas: the norm's partial sums a group
FIELDS = 6        # csrc/adamw.cu's kFields: numel, p, g, m, v, flags a leaf
# a leaf's flags (csrc/adamw.cu's kParamF32, kAligned, kGradF32): float32 p
# (else bf16); p, g, m and v on 16 bytes; float32 g (else bf16)
PARAM_F32, ALIGNED, GRAD_F32 = 1, 2, 4
DTYPES = (torch.bfloat16, torch.float32)  # of p, and of g, each
_PLAIN = (torch.Tensor, torch.nn.Parameter)  # not a DTensor or another subclass

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("adamw")
    lib.adamw_norm.argtypes = [_I, _P, _P, _P]
    lib.adamw_norm.restype = _I
    lib.adamw_update.argtypes = [_I, _P, _P, _I, _P, _P, _I] + [_F] * 9 + [_P]
    lib.adamw_update.restype = _I
    lib.adamw_kernel_info.argtypes = [_I, ctypes.POINTER(_I)]
    lib.adamw_kernel_info.restype = _I
    return lib


def on_card(params) -> bool:
    """Whether any leaf of the tree is on a CUDA device: there AdamW runs
    O1 alone, and ``adamw_step`` refuses a tree it cannot take."""
    return any(p.device.type == "cuda" for p in params)


def _layout(placements, sizes) -> tuple:
    """A DTensor's placements with every mesh axis of one rank as
    ``Replicate``: a shard over one rank is the whole extent."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if n == 1 else pl for pl, n in zip(placements, sizes))


def _in_norm(placements, coordinate) -> bool:
    """Whether this rank's shard of a leaf laid out as ``placements`` enters
    the norm: only the rank at coordinate 0 of every axis the leaf is
    replicated over counts it, so the sum over the mesh counts each element
    once."""
    from torch.distributed.tensor import Shard

    return all(isinstance(pl, Shard) or c == 0 for pl, c in zip(placements, coordinate))


def _refused(i, p, why) -> ValueError:
    return ValueError(f"AdamW on the card runs O1, which cannot take leaf {i} "
                      f"({tuple(p.shape)}, {p.dtype}): {why}")


def local_tree(params, grads, m, v) -> tuple:
    """(p, g, m, v, in_norm, mesh): the plain tensors O1 updates and, a
    leaf each, whether this rank's copy enters the norm. A tree of plain
    tensors is its own (every leaf in the norm, mesh None); a tree of
    DTensors on one mesh gives their local shards, which correspond element
    for element where a leaf's four tensors lie alike (``_layout``), and
    the mesh, over which the norm's partials are summed (``_in_norm``).
    Every local tensor contiguous on the first param's device, p and g bf16
    or float32, m and v float32 of p's shape. Raises ValueError naming the
    first leaf that is not so: ZeRO-1's moments sharded over a 'data' axis
    of more than one rank, as no step on the card has them, among them."""
    if not params or not len(params) == len(grads) == len(m) == len(v):
        raise ValueError(f"AdamW's tree: {len(params)} params, {len(grads)} grads, "
                         f"{len(m)} m and {len(v)} v")
    mesh = None
    if not all(type(t) in _PLAIN for t in (*params, *grads, *m, *v)):
        from torch.distributed.tensor import DTensor

        mesh = getattr(params[0], "device_mesh", None)
    out = ([], [], [], [], [])
    for i, leaf in enumerate(zip(params, grads, m, v)):
        p = leaf[0]
        counted = True
        if mesh is not None:
            if not all(isinstance(t, DTensor) and t.device_mesh == mesh for t in leaf):
                raise _refused(i, p, "not every tensor of it a DTensor on the first's mesh")
            sizes = mesh.shape
            layouts = [_layout(t.placements, sizes) for t in leaf]
            if any(lay != layouts[0] for lay in layouts):
                axes = dict(zip(mesh.mesh_dim_names, sizes))
                raise _refused(i, p, f"its p, g, m, v lie apart on mesh {axes}: placed "
                                     f"{[tuple(t.placements) for t in leaf]}")
            if any(pl.is_partial() for pl in layouts[0]):
                raise _refused(i, p, f"a partial placement {layouts[0]}")
            counted = _in_norm(layouts[0], mesh.get_coordinate())
            leaf = tuple(t.to_local() for t in leaf)
        lp, lg, lm, lv = leaf
        dev = out[0][0].device if out[0] else lp.device
        for what, t in zip("pgmv", leaf):
            if type(t) not in _PLAIN:
                raise _refused(i, p, f"{what} is a {type(t).__name__}")
            if t.device != dev:
                raise _refused(i, p, f"{what} on {t.device}, the first param on {dev}")
            if not t.is_contiguous():
                raise _refused(i, p, f"{what} not contiguous")
        if lp.dtype not in DTYPES or lg.dtype not in DTYPES:
            raise _refused(i, p, f"p {lp.dtype} and g {lg.dtype}, not bf16 or float32")
        if lm.dtype != torch.float32 or lv.dtype != torch.float32:
            raise _refused(i, p, f"m {lm.dtype} and v {lv.dtype}, not float32")
        if not lg.shape == lm.shape == lv.shape == lp.shape:
            raise _refused(i, p, f"shapes {[tuple(t.shape) for t in leaf]} differ")
        for lst, t in zip(out, (*leaf, counted)):
            lst.append(t)
    return (*out, mesh)


def _tables(params, grads, m, v, in_norm=None) -> list:
    """The leaves as ``csrc/adamw.cu``'s host tables, ``MAX_LEAVES`` a
    group: [(count, int64 array)]. A leaf out of ``in_norm`` counts no
    element (the norm's table)."""
    groups = []
    for lo in range(0, len(params), MAX_LEAVES):
        fields = []
        for j, (p, g, mm, vv) in enumerate(
                zip(*(t[lo:lo + MAX_LEAVES] for t in (params, grads, m, v))), lo):
            ptrs = (p.data_ptr(), g.data_ptr(), mm.data_ptr(), vv.data_ptr())
            flags = (PARAM_F32 if p.dtype == torch.float32 else 0) | \
                (GRAD_F32 if g.dtype == torch.float32 else 0) | \
                (ALIGNED if not any(a % 16 for a in ptrs) else 0)
            n = p.numel() if in_norm is None or in_norm[j] else 0
            fields += (n, *ptrs, flags)
        groups.append((len(fields) // FIELDS, (ctypes.c_longlong * len(fields))(*fields)))
    return groups


def adamw_norm(tables: list, partials: torch.Tensor, stream: int) -> None:
    """The norm's partial sums of every group: group i's into
    ``partials[i * NORM_CTAS:(i + 1) * NORM_CTAS]`` (float64)."""
    for i, (count, table) in enumerate(tables):
        raise_on(_lib().adamw_norm(count, table, partials.data_ptr() + 8 * i * NORM_CTAS,
                                   stream), "adamw_norm")
        adamw_norm.launches += 1


def adamw_update(tables: list, partials: torch.Tensor, gnorm: torch.Tensor,
                 lr: torch.Tensor, step: int, cfg, stream: int) -> None:
    """AdamW's update of every group, after ``adamw_norm``; the first
    launch writes ``gnorm`` and ``lr``. Each Python float reaches the kernel
    rounded to float32, as torch rounds a scalar for a float32 tensor
    (``1 - b1`` taken in double first, as the eager route takes it)."""
    hyper = (cfg.grad_clip, cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps, cfg.weight_decay,
             cfg.lr, max(cfg.warmup_steps, 1))
    for i, (count, table) in enumerate(tables):
        out = (gnorm.data_ptr(), lr.data_ptr()) if i == 0 else (None, None)
        raise_on(_lib().adamw_update(count, table, partials.data_ptr(), partials.numel(), *out,
                                     step, *hyper, stream), "adamw_update")
        adamw_update.launches += 1


adamw_norm.launches = 0
adamw_update.launches = 0


def adamw_step(params, grads, m, v, step: int, cfg) -> tuple:
    """AdamW's update number ``step`` (1, 2, ...) of ``params``, ``m`` and
    ``v`` in place from ``grads``, as ``optimizers.update_eager`` computes
    it, over the tree's local tensors (``local_tree``, which refuses what
    O1 cannot take); returns (grad_norm, lr), 0-dim float32 tensors on the
    card, written by the kernels, the same on every rank of a mesh."""
    p, g, mm, vv, in_norm, mesh = local_tree(params, grads, m, v)
    dev = p[0].device
    tables = _tables(p, g, mm, vv)
    partials = torch.empty(len(tables) * NORM_CTAS, dtype=torch.float64, device=dev)
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    lr = torch.empty((), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    adamw_norm(tables if all(in_norm) else _tables(p, g, mm, vv, in_norm), partials, stream)
    if mesh is not None and mesh.size() > 1:
        partials = _sum_over(mesh, partials)
    adamw_update(tables, partials, gnorm, lr, step, cfg, stream)
    # written through their pointers: autograd learns of the in-place change
    torch.autograd.graph.increment_version([*p, *mm, *vv])
    return gnorm, lr


def _sum_over(mesh, partials: torch.Tensor) -> torch.Tensor:
    """The norm's partials summed over every rank of ``mesh`` by DTensor's
    reduction, as the eager route's norm of DTensors is: every rank then
    finishes the same norm."""
    from torch.distributed.tensor import DTensor, Partial

    return DTensor.from_local(partials, mesh, [Partial()] * mesh.ndim,
                              run_check=False).full_tensor()


# in csrc/adamw.cu's adamw_kernel_info order
KERNELS = ("adamw_norm_kernel", "adamw_update_kernel")


def kernel_info() -> dict:
    """{kernel: {"registers", "ctas_per_sm", "threads", "local_bytes"}} of
    each kernel on the current CUDA device."""
    info = {}
    for which, name in enumerate(KERNELS):
        out = (_I * 4)()
        raise_on(_lib().adamw_kernel_info(which, out), "adamw_kernel_info")
        info[name] = dict(zip(("registers", "ctas_per_sm", "threads", "local_bytes"), out))
    return info
