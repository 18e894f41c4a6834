"""Operation scan: FLOPs, bytes and collective wire bytes of the aten ops a
piece of eager PyTorch dispatches (torch counterpart of
``repro.launch.hloscan``).

The reference scans the compiled HLO text of a jitted step. The port has no
compiled artifact: eager PyTorch runs the ops a step dispatches, one kernel
(or collective) each, so those ops are what it scans. ``OpScan`` is a
``TorchDispatchMode``; under it every op is counted once per dispatch, on
the shapes of this rank's tensors. A DTensor op is passed on to DTensor
(the mode declines it), which dispatches its local ops and its
redistribution collectives on the local shards, and those are counted: the
totals are per device. With ``FakeTensorMode`` and a ``fake`` process group
(``launch/dryrun.py``) nothing is computed or sent, and the counts are the
same.

Three outputs, hloscan's (``Analysis``):

  flops : 2 * out * contracting per product (``mm``, ``bmm``, ``addmm``,
          ``baddbmm``, convolutions, attention kernels: the formulas
          ``torch.utils.flop_counter`` registers, hloscan's ``_dot_flops``
          formula), + 1 per output element of the elementwise and reduction
          ops of hloscan's ``ELEMENTWISE_FLOP`` under their aten names.
          ``product_flops`` holds the products' share alone.
  bytes : every input and output tensor of every op that moves data (views
          and allocations move none). Eager PyTorch fuses nothing, so this
          is the traffic the eager port really moves; hloscan counts XLA's
          fusions at their boundaries, which is less.
  wire  : per collective, its output bytes times hloscan's ring factor
          (``_wire_factor``, copied), by kind: the functional collectives
          DTensor dispatches, and the calls of ``torch.distributed``'s
          all-reduce, all-gather, reduce-scatter and all-to-all (the FPISA
          aggregation's; a c10d call may reach its group without passing
          the dispatcher, so the mode wraps those functions while it is
          active); sends and broadcasts count as collective-permute (their
          bytes once). Collectives also move their output's bytes twice
          through memory, as hloscan charges them.

DTensor runs an op once on fake global-shape tensors to derive its output's
shape, the first time it meets the op's input layouts; those runs compute
nothing on the device and are not counted.

No trip-count multiplier: hloscan exists because XLA's cost analysis
visits a while body once (``hloscan.py:3-7``); eager PyTorch dispatches
every layer's ops, so every one is counted as it runs.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# hloscan's ELEMENTWISE_FLOP, under the aten op names that compute them
ELEMENTWISE_FLOP = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg", "exp", "log",
    "tanh", "rsqrt", "sqrt", "pow", "eq", "ne", "lt", "le", "gt", "ge", "where",
    "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "bitwise_left_shift", "bitwise_right_shift", "__lshift__",
    "__rshift__", "floor", "ceil", "round", "sign", "_to_copy", "cos", "sin", "sigmoid",
    "sum", "mean", "amax", "amin", "max", "min", "clamp", "clamp_min", "clamp_max",
    "remainder", "atan2", "expm1", "log1p", "_softmax", "_log_softmax", "silu", "gelu",
    "reciprocal", "square", "cumsum", "cummax", "sort", "tanh_backward", "sigmoid_backward",
    "_softmax_backward_data", "_log_softmax_backward_data", "gelu_backward", "silu_backward",
}
# ops that move no bytes: allocations and metadata
NO_BYTES = {"empty", "empty_strided", "empty_like", "detach", "lift_fresh", "alias", "_local_scalar_dense"}
COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute", "broadcast_": "collective-permute",
}
NO_WIRE = {"wait_tensor", "barrier", "monitored_barrier_"}
# DTensor's output-shape propagation (private; where a version lacks it,
# its shadow ops are counted)
SHADOW = "_propagate_tensor_meta_non_cached"


def _wire_factor(kind: str, size: float, k: int) -> float:
    if kind == "all-reduce":
        return size * 2 * (k - 1) / k
    if kind == "all-gather":
        return size * (k - 1) / k
    if kind == "reduce-scatter":
        return size * (k - 1)
    if kind == "all-to-all":
        return size * (k - 1) / k
    return size  # collective-permute


@dataclasses.dataclass
class Analysis:
    flops: float = 0.0
    product_flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)

    def add_collective(self, kind: str, wire: float, count: float):
        agg = self.collectives.setdefault(kind, {"count": 0.0, "wire": 0.0})
        agg["count"] += count
        agg["wire"] += wire


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a collective names: a ProcessGroup
    argument (c10d ops) or its ``group_name`` (functional collectives)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    for i, spec in enumerate(func._schema.arguments):
        if spec.name == "group_name":
            name = args[i] if i < len(args) else kwargs[spec.name]
            return _resolve_process_group(name).size()
    return 1


# torch.distributed's functions, counted where they are called: a c10d
# collective called through them may reach its process group without
# passing the dispatcher. kind, and which argument holds the output
C10D = {"all_reduce": ("all-reduce", 0), "all_gather": ("all-gather", 0),
        "all_gather_into_tensor": ("all-gather", 0), "reduce_scatter_tensor": ("reduce-scatter", 0),
        "all_to_all_single": ("all-to-all", 0), "broadcast": ("collective-permute", 0),
        "send": ("collective-permute", 0)}


class OpScan(TorchDispatchMode):
    """Counts the ops dispatched inside the block, and the calls of
    torch.distributed's collectives, into ``self.analysis``."""

    def __init__(self):
        super().__init__()
        self.analysis = Analysis()
        self._saved = {}
        self._in_c10d = 0
        self._shadow = 0

    def __enter__(self):
        import torch.distributed as dist
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        # DTensor derives an op's output shape by running it once on fake
        # global-shape tensors (the first time it meets the op's input
        # layouts); that run computes nothing and is not counted
        meta = getattr(ShardingPropagator, SHADOW, None)
        if meta is not None:
            self._saved[SHADOW] = meta

            def shadow(prop, *args, **kwargs):
                self._shadow += 1
                try:
                    return meta(prop, *args, **kwargs)
                finally:
                    self._shadow -= 1
            setattr(ShardingPropagator, SHADOW, shadow)
        for name, (kind, out) in C10D.items():
            self._saved[name] = fn = getattr(dist, name)
            setattr(dist, name, self._counted(fn, kind, out))
        self._saved["batch_isend_irecv"] = fn = dist.batch_isend_irecv
        dist.batch_isend_irecv = self._counted_p2p(fn)
        return super().__enter__()

    def __exit__(self, *exc):
        import torch.distributed as dist
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        for name, fn in self._saved.items():
            setattr(ShardingPropagator if name == SHADOW else dist, name, fn)
        self._saved = {}
        return super().__exit__(*exc)

    def _collective(self, kind: str, size: int, k: int):
        acc = self.analysis
        if k > 1:
            wire = _wire_factor(kind, size, k)
            acc.wire_bytes += wire
            acc.add_collective(kind, wire, 1)
        acc.hbm_bytes += 2 * size

    def _counted(self, fn, kind: str, out: int):
        import torch.distributed as dist

        def call(*args, **kwargs):
            group = kwargs.get("group")
            self._collective(kind, _bytes(_tensors(args[out])), dist.get_world_size(group))
            self._in_c10d += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._in_c10d -= 1
        return call

    def _counted_p2p(self, fn):
        def call(ops):
            for op in ops:
                if getattr(op.op, "__name__", "") == "isend":
                    self._collective("collective-permute", _bytes([op.tensor]), 2)
            self._in_c10d += 1
            try:
                return fn(ops)
            finally:
                self._in_c10d -= 1
        return call

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor dispatches its local ops, counted below
        out = func(*args, **kwargs)
        if not self._shadow:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        acc = self.analysis
        packet = func._overloadpacket
        name = packet.__name__
        if name in NO_WIRE:
            return
        if name in COLLECTIVES:
            if self._in_c10d and str(func.namespace) == "c10d":
                return  # counted where torch.distributed was called
            self._collective(COLLECTIVES[name], _bytes(_tensors(out) or _tensors(args[:1])),
                             _group_size(func, args, kwargs))
            return
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            acc.flops += f
            acc.product_flops += f
        elif name.rstrip("_") in ELEMENTWISE_FLOP or name in ELEMENTWISE_FLOP:
            acc.flops += sum(t.numel() for t in _tensors(out))
        if func.is_view or name in NO_BYTES or str(func.namespace) == "prim":
            return
        acc.hbm_bytes += _bytes(_tensors((args, kwargs))) + _bytes(_tensors(out))


def analyze(fn, *args, **kwargs) -> tuple:
    """(fn's result, the Analysis of the ops it dispatched)."""
    with OpScan() as scan:
        result = fn(*args, **kwargs)
    return result, scan.analysis
