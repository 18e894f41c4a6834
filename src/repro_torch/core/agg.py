"""The ``Aggregator`` facade with a pluggable strategy registry (torch port of
``repro.core.agg``).

* :class:`AggConfig`    — every aggregation knob in one frozen config, with
                          the reference's fields and defaults.
* :class:`Aggregator`   — constructed once from an ``AggConfig`` plus the
                          ``torch.distributed`` process group it reduces over
                          (``None``: the default group, or a world of one when
                          no group is initialised), or a pair
                          ``(pod_group, data_group)`` for the reference's
                          two-axis ``("pod", "data")`` layout
                          (``runtime/elastic.py::make_groups``);
                          ``agg.allreduce(x)`` and ``agg.allreduce_tree(tree)``.
                          It owns chunked streaming, hierarchical routing,
                          logical-worker stacking (``stacked=True``: a leading
                          worker axis, reduced with it) and tree bucketing
                          (``core/bucketer.py``). All capability checks
                          happen at construction.
* :func:`register_strategy` — the registry; the built-in strategies
                          (``native``, ``switchml``, ``fpisa``,
                          ``fpisa_seq``, ``switch_emu``) live in
                          ``repro_torch.core.allreduce``.
* :func:`add_agg_args` / :meth:`AggConfig.from_args` — the ``--agg-*`` flags.

Backends (``AggConfig.backend``) choose where the FPISA encode/decode (and
``fpisa_seq``'s sequential sum) run:

``"torch"`` : the plain reference formulation (``fpisa.encode`` /
              ``block_decode`` / ``fpisa_sum_sequential``), on any device.
``"cuda"``  : the hand-written Hopper kernels (``kernels/ops.py``); a CPU
              tensor raises.
``"auto"``  : ``"cuda"`` for a CUDA tensor, ``"torch"`` for a CPU tensor.

A group pair routes a strategy with a hierarchical variant (``fpisa``)
through it; every other strategy reduces over both groups in turn (data,
then pod), which is the flat reduction over the pair's ranks. Stacked
aggregation reduces a pair jointly (flat), as the reference does.
"""
from __future__ import annotations

import argparse
import dataclasses
import difflib
import math
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch import trace as _trace

DEFAULT_BLOCK = 256

BACKENDS = ("auto", "torch", "cuda")


def _did_you_mean(name: str, options: Sequence[str]) -> str:
    close = difflib.get_close_matches(name, options, n=1)
    return f"; did you mean {close[0]!r}?" if close else ""


def resolve_backend(backend: str, device: torch.device | None = None) -> str:
    """Validate ``backend`` and, given the tensor's device, resolve it to
    ``"torch"`` or ``"cuda"``. ``"cuda"`` for a non-CUDA device raises."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown aggregation backend {backend!r}; valid backends: "
            f"{', '.join(BACKENDS)}{_did_you_mean(backend, BACKENDS)}")
    if device is None:
        return backend
    on_card = torch.device(device).type == "cuda"
    if backend == "cuda" and not on_card:
        raise ValueError(
            f"backend 'cuda' runs the Hopper kernels and takes CUDA tensors "
            f"only, got a tensor on {device}; use backend 'auto' or 'torch'")
    if backend == "auto":
        return "cuda" if on_card else "torch"
    return backend


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AggConfig:
    """Every aggregation knob in one frozen config (strategy docs in
    ``repro_torch.core.allreduce``)."""

    strategy: str = "fpisa"
    block: int = DEFAULT_BLOCK
    wire_bits: int = 32
    fmt_name: str = "fp32"
    # wire bits for the cross-pod hop when hierarchical (defaults to wire_bits)
    pod_wire_bits: int | None = None
    # stream one tensor's aggregation through chunks of this many elements,
    # so the integer planes of only one chunk are live; 0 disables
    chunk_elems: int = 0
    # encode/decode backend: "auto" | "torch" | "cuda" (module doc)
    backend: str = "auto"
    # tree-level bucketing (core/bucketer.py): the gradient tree goes on the
    # wire as fixed-size block-aligned buckets, dispatched double-buffered,
    # bit-identical to the per-leaf path; 0 = per leaf
    bucket_bytes: int = 0
    # multi-tenant switch emulation (switch_emu only): name a process-shared
    # emulated dataplane and this aggregator's tenant on it, so several jobs
    # (plus query streams) contend for one switch. None = a private
    # single-tenant dataplane per call.
    switch_shared: str | None = None
    switch_jobs: int = 1
    switch_job: int = 0

    def __post_init__(self):
        resolve_backend(self.backend)
        if not 0 <= self.switch_job < self.switch_jobs:
            raise ValueError(
                f"switch_job must be in [0, switch_jobs={self.switch_jobs}), "
                f"got {self.switch_job}")

    @property
    def fmt(self):
        from repro_torch.core import fpisa

        return fpisa.FORMATS[self.fmt_name]

    @classmethod
    def from_args(cls, ns: argparse.Namespace) -> "AggConfig":
        """Build the config from a namespace produced by a parser that went
        through :func:`add_agg_args`; validates strategy, backend and the
        strategy's own checks now.

        ``--bucket-bytes auto`` resolves here, once, to a byte count through
        the cost-model autotuner (``repro_torch.autotune``): the trace named
        by ``--autotune-trace`` (or $REPRO_AUTOTUNE_TRACE) is fitted and the
        candidate sweep picks the plan; with no trace it falls back loudly
        to the measured-good default. The config always carries an int."""
        bucket_bytes = getattr(ns, "bucket_bytes", 0)
        block = getattr(ns, "agg_block", None) or DEFAULT_BLOCK
        if isinstance(bucket_bytes, str):
            from repro_torch.autotune import search as _search

            bucket_bytes = _search.auto_bucket_bytes(
                trace_path=getattr(ns, "autotune_trace", None), block=block)
        cfg = cls(
            strategy=getattr(ns, "agg_strategy", "fpisa"),
            backend=getattr(ns, "agg_backend", "auto"),
            wire_bits=getattr(ns, "agg_wire_bits", None) or 32,
            pod_wire_bits=getattr(ns, "agg_pod_wire_bits", None),
            fmt_name=getattr(ns, "agg_fmt", None) or "fp32",
            chunk_elems=getattr(ns, "agg_chunk", 0),
            bucket_bytes=bucket_bytes,
            block=block,
        )
        spec = get_strategy(cfg.strategy)
        _check_config(cfg, spec)
        return cfg


def _bucket_bytes_flag(value: str):
    """argparse type for ``--bucket-bytes``: an int, or the literal "auto"
    (resolved by the cost-model autotuner in ``AggConfig.from_args``)."""
    if value.strip().lower() == "auto":
        return "auto"
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--bucket-bytes expects an integer byte count or 'auto', "
            f"got {value!r}") from None


def add_agg_args(parser: argparse.ArgumentParser, *,
                 default_strategy: str = "fpisa"):
    """Register the shared ``--agg-*`` flags on ``parser`` (the reference's
    spellings and aliases)."""
    g = parser.add_argument_group(
        "aggregation", "FPISA aggregation facade (repro_torch.core.agg)")
    g.add_argument(
        "--agg-strategy", "--agg", dest="agg_strategy",
        default=default_strategy, metavar="NAME",
        help=f"aggregation strategy (registry: {', '.join(available_strategies())})")
    g.add_argument(
        "--agg-backend", default="auto", metavar="NAME",
        help="encode/decode backend: auto | torch | cuda (Hopper kernels for "
             "CUDA tensors under auto)")
    g.add_argument(
        "--agg-chunk", type=int, default=0, metavar="N",
        help="stream each tensor's aggregation through chunks of this many "
             "elements (bounds transient plane memory; 0 = whole tensor)")
    g.add_argument(
        "--bucket-bytes", type=_bucket_bytes_flag, default=0, metavar="N",
        help="put the gradient tree on the wire as fixed-size block-aligned "
             "buckets dispatched double-buffered (core/bucketer.py; "
             "bit-identical to per-leaf; 0 = per leaf; 'auto' = pick with the "
             "cost-model autotuner, see --autotune-trace)")
    g.add_argument(
        "--autotune-trace", default=None, metavar="PATH",
        help="span trace (JSONL from --trace-out or "
             "repro_torch.autotune.profile_phases) the '--bucket-bytes auto' "
             "cost model is fitted from; default $REPRO_AUTOTUNE_TRACE")
    g.add_argument(
        "--agg-wire-bits", "--wire-bits", dest="agg_wire_bits", type=int,
        default=32, choices=[8, 16, 32],
        help="wire element width for the integer collective")
    g.add_argument(
        "--agg-pod-wire-bits", "--pod-wire-bits", dest="agg_pod_wire_bits",
        type=int, default=None, choices=[8, 16, 32],
        help="narrower wire for the cross-pod hop of a hierarchical "
             "(pod, data) group pair (default: --agg-wire-bits)")
    g.add_argument(
        "--agg-fmt", default="fp32", choices=["fp32", "fp16", "bf16"],
        help="packed floating-point format of the aggregated values")
    g.add_argument(
        "--agg-block", type=int, default=DEFAULT_BLOCK, metavar="N",
        help="FPISA block size (elements sharing one exponent)")
    return g


# ---------------------------------------------------------------------------
# strategy registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """One registered aggregation strategy with its capability flags.

    ``fn`` / ``stacked_fn`` take ``(x, group, cfg)``; ``hierarchical_fn``
    takes ``(x, data_group, pod_group, cfg)``. The ``*_phases`` hooks are
    optional split-phase pipeline factories consumed by ``core/bucketer.py``
    for double-buffered dispatch; a strategy without them streams through
    the one-shot path with the same interleaving."""

    name: str
    fn: Callable
    stacked_fn: Callable | None = None
    hierarchical_fn: Callable | None = None
    # capability flags (validated once, at Aggregator construction)
    supports_chunking: bool = True
    # chunking is an identity for elementwise strategies (native float sum):
    # the chunk loop is skipped rather than paid
    chunk_noop: bool = False
    # optional config validator: raises on combinations the strategy cannot
    # honor (e.g. switch_emu's numpy dataplane is fp32-only)
    validate: Callable | None = None
    # bucketer staging dtype: (cfg, dtype_group_name) -> torch dtype the
    # bucket buffer is assembled in (defaults to float32)
    stage_dtype: Callable | None = None
    # split-phase pipeline factories for the bucketer's double-buffering:
    #   flat_phases(group, cfg, backend)                        -> (enc, coll, fin)
    #   hier_phases(data_group, pod_group, cfg, backend, stripe) -> (enc, coll, fin)
    #   stacked_phases(group, cfg, backend, k)                  -> (enc, coll, fin)
    flat_phases: Callable | None = None
    hier_phases: Callable | None = None
    stacked_phases: Callable | None = None
    description: str = ""

    @property
    def supports_stacking(self) -> bool:
        return self.stacked_fn is not None


_REGISTRY: dict[str, StrategySpec] = {}


def register_strategy(name: str, *, stacked: Callable | None = None,
                      hierarchical: Callable | None = None,
                      supports_chunking: bool = True, chunk_noop: bool = False,
                      validate: Callable | None = None,
                      stage_dtype: Callable | None = None,
                      flat_phases: Callable | None = None,
                      hier_phases: Callable | None = None,
                      stacked_phases: Callable | None = None,
                      description: str = "", overwrite: bool = False):
    """Decorator registering ``fn(x, group, cfg)`` as strategy ``name`` with
    its capability flags and hooks (``StrategySpec``). Re-registering an
    existing name requires ``overwrite=True``."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY and not overwrite:
            raise ValueError(
                f"aggregation strategy {name!r} is already registered "
                f"(pass overwrite=True to replace it)")
        _REGISTRY[name] = StrategySpec(
            name=name, fn=fn, stacked_fn=stacked, hierarchical_fn=hierarchical,
            supports_chunking=supports_chunking, chunk_noop=chunk_noop,
            validate=validate, stage_dtype=stage_dtype,
            flat_phases=flat_phases, hier_phases=hier_phases,
            stacked_phases=stacked_phases,
            description=description or (fn.__doc__ or "").split("\n")[0])
        return fn

    return deco


def unregister_strategy(name: str) -> None:
    """Remove a registered strategy (test/plugin teardown); an unknown name
    is ignored."""
    _REGISTRY.pop(name, None)


def _ensure_builtin() -> None:
    # the built-in strategies register themselves when repro_torch.core.
    # allreduce is imported; importing lazily breaks the module cycle
    if "fpisa" not in _REGISTRY:
        from repro_torch.core import allreduce  # noqa: F401


def available_strategies() -> tuple[str, ...]:
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))


def get_strategy(name: str) -> StrategySpec:
    """Look up a strategy; unknown names fail with the registered options and
    the nearest match."""
    _ensure_builtin()
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(
        f"unknown aggregation strategy {name!r}; registered strategies: "
        f"{', '.join(sorted(_REGISTRY))}{_did_you_mean(name, sorted(_REGISTRY))}")


# ---------------------------------------------------------------------------
# process groups and trees
# ---------------------------------------------------------------------------


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    """Ranks reduced over: the group's size (the product over a
    ``(pod_group, data_group)`` pair), or 1 with no process group."""
    if not _initialized():
        return 1
    if isinstance(group, tuple):
        return math.prod(dist.get_world_size(g) for g in group)
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This rank's index over ``group``: its rank in the group, over a pair
    ``pod * w_data + data`` (the mesh layout of ``runtime/elastic.py``); 0
    with no process group."""
    if not _initialized():
        return 0
    if isinstance(group, tuple):
        pod_group, data_group = group
        return (dist.get_rank(pod_group) * dist.get_world_size(data_group)
                + dist.get_rank(data_group))
    return dist.get_rank(group)


def tree_flatten(tree):
    """(leaves, unflatten): the tensors of a dict/list/tuple tree in its own
    order (dict insertion order), and the function that rebuilds the tree's
    structure from a list of new leaves."""
    leaves: list[torch.Tensor] = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return len(leaves) - 1
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        raise TypeError(f"allreduce_tree takes tensors in dicts/lists/tuples, "
                        f"got {type(t).__name__}")

    skeleton = walk(tree)

    def unflatten(values):
        def build(s):
            if isinstance(s, int):
                return values[s]
            if isinstance(s, dict):
                return {k: build(v) for k, v in s.items()}
            return type(s)(build(v) for v in s)

        return build(skeleton)

    return leaves, unflatten


# ---------------------------------------------------------------------------
# dispatch (internal: consumers go through Aggregator)
# ---------------------------------------------------------------------------


def _dispatch(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """Single-tensor dispatch: chunked loop -> hierarchical -> flat."""
    spec = get_strategy(cfg.strategy)
    if cfg.chunk_elems and not spec.chunk_noop and x.numel() > cfg.chunk_elems:
        if not spec.supports_chunking:
            raise ValueError(
                f"strategy {cfg.strategy!r} does not support chunk_elems")
        return _chunked(x, group, cfg)
    if isinstance(group, tuple) and spec.hierarchical_fn is not None:
        pod_group, data_group = group
        return spec.hierarchical_fn(x, data_group, pod_group, cfg)
    return spec.fn(x, group, cfg)


def _dispatch_stacked(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """Stacked (leading logical-worker axis) dispatch."""
    spec = get_strategy(cfg.strategy)
    if x.dim() < 1:
        raise ValueError("stacked aggregation needs a leading worker axis")
    if cfg.chunk_elems:
        raise NotImplementedError(
            "chunk_elems is not supported with stacked (logical-worker) "
            "aggregation; use bucket_bytes to bound transient memory instead")
    if spec.stacked_fn is None:
        raise ValueError(
            f"strategy {cfg.strategy!r} does not support stacked "
            f"(logical-worker) aggregation")
    return spec.stacked_fn(x, group, cfg)


def _chunked(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """Stream the aggregation through fixed-size chunks, one at a time, so
    the integer planes of only one chunk are live. The last chunk is padded
    with zeros to the full chunk size, as the reference pads the tensor."""
    inner = dataclasses.replace(cfg, chunk_elems=0)
    size = cfg.chunk_elems
    flat = x.reshape(-1)
    n = flat.shape[0]
    out = torch.empty_like(flat)
    for start in range(0, n, size):
        piece = flat[start:start + size]
        take = piece.shape[0]
        if take < size:
            piece = torch.cat([piece, piece.new_zeros(size - take)])
        out[start:start + take].copy_(_dispatch(piece, group, inner)[:take])
    return out.reshape(x.shape)


def _check_config(cfg: AggConfig, spec: StrategySpec) -> None:
    """The construction-time checks of a config against its strategy."""
    if cfg.chunk_elems and not (spec.supports_chunking or spec.chunk_noop):
        raise ValueError(
            f"strategy {cfg.strategy!r} does not support chunk_elems "
            f"(set chunk_elems=0)")
    if cfg.bucket_bytes and cfg.chunk_elems and cfg.chunk_elems % cfg.block:
        raise ValueError(
            f"bucket_bytes with chunk_elems requires chunk_elems to be a "
            f"multiple of block={cfg.block} for bit-identity "
            f"(got chunk_elems={cfg.chunk_elems}; see core/bucketer.py)")
    if spec.validate is not None:
        spec.validate(cfg)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


class Aggregator:
    """The one aggregation entry point (module doc).

        agg = Aggregator(AggConfig(strategy="fpisa"))   # default group
        y    = agg.allreduce(x)        # one tensor
        tree = agg.allreduce_tree(g)   # dict/list of gradient tensors (bucketed
                                       # when cfg.bucket_bytes is set)

    ``group`` is a ``torch.distributed`` process group, ``None``, or a pair
    ``(pod_group, data_group)`` in the reference's ``("pod", "data")`` axis
    order. ``stacked=True`` selects logical-worker mode: every input carries
    a leading worker axis of size k (this rank's k of the job's W = k x
    world logical workers) and the reduction runs over that axis and the
    group through the strategy's stacked variant, whose bits are the same
    for every placement of the W workers (``core/allreduce.py``)."""

    def __init__(self, cfg: AggConfig, group=None, *, stacked: bool = False):
        if isinstance(group, list):
            group = tuple(group)
        if isinstance(group, tuple):
            if len(group) == 1:
                group = group[0]
            elif len(group) != 2:
                raise ValueError(
                    f"group must be a process group or a (pod_group, data_group) "
                    f"pair, got {len(group)} groups")
        self.cfg = cfg
        self.group = group
        self.stacked = bool(stacked)
        self.spec = get_strategy(cfg.strategy)
        if self.stacked and not self.spec.supports_stacking:
            capable = [s for s in available_strategies() if get_strategy(s).supports_stacking]
            raise ValueError(
                f"strategy {cfg.strategy!r} does not support stacked "
                f"(logical-worker) aggregation; stacked-capable strategies: "
                f"{', '.join(capable)}")
        if self.stacked and cfg.chunk_elems:
            raise ValueError(
                "chunk_elems is not supported with stacked (logical-worker) "
                "aggregation; use bucket_bytes to bound transient memory "
                "instead")
        _check_config(cfg, self.spec)

    def __repr__(self) -> str:
        return (f"Aggregator(strategy={self.spec.name!r}, backend={self.cfg.backend!r}, "
                f"stacked={self.stacked}, chunk_elems={self.cfg.chunk_elems}, "
                f"bucket_bytes={self.cfg.bucket_bytes})")

    def allreduce(self, x: torch.Tensor) -> torch.Tensor:
        """Aggregate one tensor over the group (a new tensor; x is not
        modified); with ``stacked``, over its leading logical-worker axis
        too."""
        with _trace.span("agg.allreduce", strategy=self.spec.name,
                         stacked=self.stacked) as sp:
            if sp:
                sp.tag(backend=resolve_backend(self.cfg.backend, x.device))
            if self.stacked:
                out = _dispatch_stacked(x, self.group, self.cfg)
            else:
                out = _dispatch(x, self.group, self.cfg)
            sp.sync(out)
        return out

    def allreduce_tree(self, tree):
        """Aggregate every leaf of a gradient tree.

        With ``cfg.bucket_bytes`` set, the whole tree goes on the wire as
        fixed-size block-aligned buckets streamed double-buffered
        (core/bucketer.py): bit-identical to the per-leaf path, with the
        encode/decode launches paid per bucket instead of per leaf.
        Otherwise one leaf at a time."""
        with _trace.span("agg.allreduce_tree", strategy=self.spec.name,
                         stacked=self.stacked, bucket_bytes=self.cfg.bucket_bytes) as sp:
            leaves, unflatten = tree_flatten(tree)
            if sp and leaves:
                sp.tag(backend=resolve_backend(self.cfg.backend, leaves[0].device))
            if self.cfg.bucket_bytes:
                from repro_torch.core import bucketer

                tree_fn = (bucketer.bucketed_stacked_allreduce_tree if self.stacked
                           else bucketer.bucketed_allreduce_tree)
                out = tree_fn(tree, self.group, self.cfg)
            else:
                out = unflatten([self.allreduce(leaf) for leaf in leaves])
            sp.sync(out)
        return out
