"""The ``Aggregator`` facade with a pluggable strategy registry (torch port of
``repro.core.agg``).

* :class:`AggConfig`    — every aggregation knob in one frozen config, with
                          the reference's fields and defaults.
* :class:`Aggregator`   — constructed once from an ``AggConfig`` plus the
                          ``torch.distributed`` process group it reduces over
                          (``None``: the default group, or a world of one when
                          no group is initialised); ``agg.allreduce(x)`` and
                          ``agg.allreduce_tree(tree)``. All capability checks
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

Not ported yet, and refused at construction with :class:`NotPortedError`:
stacked (logical-worker) aggregation, hierarchical (two-group) layouts,
``chunk_elems`` streaming, ``bucket_bytes`` bucketing and the multi-tenant
``switch_shared`` dataplane of ``switch_emu`` (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import dataclasses
import difflib
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch import NotPortedError

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
    # wire bits for the cross-pod hop when hierarchical (not ported yet)
    pod_wire_bits: int | None = None
    # chunked streaming (not ported yet; must be 0)
    chunk_elems: int = 0
    # encode/decode backend: "auto" | "torch" | "cuda" (module doc)
    backend: str = "auto"
    # tree-level bucketing (not ported yet; must be 0)
    bucket_bytes: int = 0
    # multi-tenant switch emulation (switch_emu only; not ported yet)
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
        strategy's own checks now."""
        bucket_bytes = getattr(ns, "bucket_bytes", 0)
        if isinstance(bucket_bytes, str):
            raise NotPortedError("--bucket-bytes auto (the cost-model autotuner)")
        cfg = cls(
            strategy=getattr(ns, "agg_strategy", "fpisa"),
            backend=getattr(ns, "agg_backend", "auto"),
            wire_bits=getattr(ns, "agg_wire_bits", None) or 32,
            pod_wire_bits=getattr(ns, "agg_pod_wire_bits", None),
            fmt_name=getattr(ns, "agg_fmt", None) or "fp32",
            chunk_elems=getattr(ns, "agg_chunk", 0),
            bucket_bytes=bucket_bytes,
            block=getattr(ns, "agg_block", None) or DEFAULT_BLOCK,
        )
        spec = get_strategy(cfg.strategy)
        _refuse_unported(cfg)
        if spec.validate is not None:
            spec.validate(cfg)
        return cfg


def _bucket_bytes_flag(value: str):
    """argparse type for ``--bucket-bytes``: an int, or the literal "auto"."""
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
        help="chunked streaming (not ported yet; 0)")
    g.add_argument(
        "--bucket-bytes", type=_bucket_bytes_flag, default=0, metavar="N",
        help="tree-level bucketing (not ported yet; 0 = per-leaf)")
    g.add_argument(
        "--agg-wire-bits", "--wire-bits", dest="agg_wire_bits", type=int,
        default=32, choices=[8, 16, 32],
        help="wire element width for the integer collective")
    g.add_argument(
        "--agg-pod-wire-bits", "--pod-wire-bits", dest="agg_pod_wire_bits",
        type=int, default=None, choices=[8, 16, 32],
        help="cross-pod wire width for hierarchical layouts (not ported yet)")
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
    """One registered aggregation strategy: ``fn(x, group, cfg)``, and an
    optional ``validate(cfg)`` run when an Aggregator is built with it."""

    name: str
    fn: Callable
    description: str = ""
    validate: Callable | None = None


_REGISTRY: dict[str, StrategySpec] = {}


def register_strategy(name: str, *, description: str = "", validate: Callable | None = None,
                      overwrite: bool = False):
    """Decorator registering ``fn(x, group, cfg)`` as strategy ``name``, with
    an optional config check ``validate(cfg)`` (raises on what it refuses).
    Re-registering an existing name requires ``overwrite=True``."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY and not overwrite:
            raise ValueError(
                f"aggregation strategy {name!r} is already registered "
                f"(pass overwrite=True to replace it)")
        _REGISTRY[name] = StrategySpec(
            name=name, fn=fn,
            description=description or (fn.__doc__ or "").split("\n")[0],
            validate=validate)
        return fn

    return deco


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
# the facade
# ---------------------------------------------------------------------------


def world_size(group=None) -> int:
    """Ranks reduced over: the group's size, or 1 with no process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _tree_map(fn: Callable, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"allreduce_tree takes tensors in dicts/lists/tuples, "
                    f"got {type(tree).__name__}")


def _refuse_unported(cfg: AggConfig) -> None:
    if cfg.chunk_elems:
        raise NotPortedError(f"chunk_elems={cfg.chunk_elems} (chunked streaming)")
    if cfg.bucket_bytes:
        raise NotPortedError(f"bucket_bytes={cfg.bucket_bytes} (bucketing)")
    if cfg.switch_shared is not None:
        raise NotPortedError(f"switch_shared={cfg.switch_shared!r} (the multi-tenant "
                             f"switch dataplane)")


class Aggregator:
    """The one aggregation entry point (module doc).

        agg = Aggregator(AggConfig(strategy="fpisa"))   # default group
        y    = agg.allreduce(x)        # one tensor
        tree = agg.allreduce_tree(g)   # dict/list of gradient tensors, per leaf

    ``group`` is a ``torch.distributed`` process group or ``None``; a pair of
    groups (the reference's two-axis ``("pod", "data")`` layout) is refused,
    as is ``stacked=True``, until their slices are ported."""

    def __init__(self, cfg: AggConfig, group=None, *, stacked: bool = False):
        if isinstance(group, (tuple, list)):
            if len(group) != 1:
                raise NotPortedError(
                    f"hierarchical aggregation over {len(group)} groups")
            group = group[0]
        if stacked:
            raise NotPortedError("stacked (logical-worker) aggregation")
        _refuse_unported(cfg)
        self.cfg = cfg
        self.group = group
        self.spec = get_strategy(cfg.strategy)
        if self.spec.validate is not None:
            self.spec.validate(cfg)

    def allreduce(self, x: torch.Tensor) -> torch.Tensor:
        """Aggregate one tensor over the group (a new tensor; x is not
        modified)."""
        return self.spec.fn(x, self.group, self.cfg)

    def allreduce_tree(self, tree):
        """Aggregate every leaf of a gradient tree, one leaf at a time (the
        reference's per-leaf path, ``bucket_bytes=0``)."""
        return _tree_map(self.allreduce, tree)
