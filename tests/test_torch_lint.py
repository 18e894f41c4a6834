"""The lint's rules for the port (``src/repro_torch``), run through
``tools.repro_lint``.

The reference's rules are scoped to ``src/repro`` or match only ``jax`` and
``np`` names, so they see nothing of the port. The port's counterparts are
defined here as plain functions and registered with ``register_rule`` only
inside the ``port_rules`` fixture, which removes them with
``unregister_rule`` at its teardown: never at import, so that
tests/test_lint.py::test_whole_repo_lints_clean, collected in the same
worker, still runs the reference's rules alone.

* ``torch-exact-scale`` (core/ and kernels/): no ``torch.exp2``,
  ``torch.ldexp``, ``torch.float_power``, ``torch.pow(2, e)``,
  ``math.exp2``, ``math.pow(2, e)`` and no ``2 ** e`` / ``2.0 ** e`` unless
  ``e`` is an integer literal (an exact constant such as ``2**31``).
* ``torch-timing-discipline``: the reference rule's checks (no
  ``time.time()``, no bare ``Span.start()``) over the port's counterparts
  of its ``_TIMING_SCOPE``; the tracer's own file is exempt.
* ``torch-rng-discipline`` (all of the port): no ``np.random`` global-state
  calls, no ``torch.manual_seed`` / ``torch.cuda.manual_seed*`` /
  ``torch.seed``, and no ``torch.rand``, ``randn``, ``randint``,
  ``randperm``, ``normal``, ``bernoulli``, ``multinomial`` without
  ``generator=``.
* ``torch-bit-identity`` (the port outside core/allreduce.py, core/agg.py
  and core/bucketer.py): no raw ``torch.distributed.all_reduce`` or
  ``reduce_scatter_tensor``, and no ``torch.sum`` / ``torch.mean`` (or the
  ``.sum()`` / ``.mean()`` method) over a name that reads as a worker or
  stacked axis, with the reference rule's name pattern.
* ``torch-mirror-parity`` (project rule): the reference's mirror-parity
  checks read from the port's tree (the layout is the same), plus what the
  port's layout adds: ``switchsim/dataplane.py`` (``BatchedDataplane`` and
  ``NumpyDataplane``) uses ``COUNTERS`` and ``SLOT_STATE_FIELDS`` from
  ``repro_torch.switchsim`` and ``core/switch.py`` its ``COUNTERS``; every
  ``*_ref`` oracle of ``kernels/ref.py`` has its kernel, ``X`` or
  ``fpisa_X``, in a ``kernels/fpisa_*.py`` module.

Each rule fires on a seeded violation and stays silent on a clean fixture;
then the real ``src/repro_torch`` lints clean under all of them.
"""
from __future__ import annotations

import ast
import dataclasses
import textwrap
from pathlib import Path

import pytest

from tools.repro_lint import Finding, available_rules, register_rule, run_lint, unregister_rule
from tools.repro_lint import mirror
from tools.repro_lint.astutil import ImportMap, dotted
from tools.repro_lint.rules import _RNG_OK, _WORKER_NAME, _is_two, _span_receiver

from test_lint import write_tree  # the reference lint tests' fixture writer

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT = "src/repro_torch"


def _finding(rule, mod, node, message):
    return Finding(rule, mod.rel, node.lineno, node.col_offset, message)


# ---------------------------------------------------------------------------
# the port's rules
# ---------------------------------------------------------------------------

_INEXACT_POW2 = {"torch.exp2", "torch.special.exp2", "torch.ldexp", "torch.float_power",
                 "math.exp2"}
_POW_FNS = {"torch.pow", "math.pow"}


def _int_literal(node) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        node = node.operand
    return isinstance(node, ast.Constant) and type(node.value) is int


def torch_exact_scale(mod, project):
    imports = ImportMap(mod.tree)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            q = imports.qualified(node.func)
            if q in _INEXACT_POW2 or (q in _POW_FNS and node.args and _is_two(node.args[0])):
                yield _finding("torch-exact-scale", mod, node,
                               f"{q}() is not an exact power-of-two scale; use the "
                               f"bit-assembled helper (core/allreduce._pow2)")
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow) \
                and _is_two(node.left) and not _int_literal(node.right):
            yield _finding("torch-exact-scale", mod, node,
                           "2 ** e with a computed exponent on a scale path; use the "
                           "bit-assembled exact pow2 helper (core/allreduce._pow2)")


_TIMING_SCOPE = tuple(f"{PORT}/{p}" for p in (
    "trace/*", "autotune/*", "core/agg.py", "core/bucketer.py", "switchsim/*", "serve/*",
    "launch/*", "runtime/controller.py"))
_TIMING_IMPL = f"{PORT}/trace/tracer.py"


def torch_timing_discipline(mod, project):
    imports = ImportMap(mod.tree)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if imports.qualified(node.func) == "time.time":
            yield _finding("torch-timing-discipline", mod, node,
                           "time.time() is wall-clock; time phases with time.perf_counter()")
        elif isinstance(node.func, ast.Attribute) and node.func.attr == "start" \
                and not node.args and not node.keywords and mod.rel != _TIMING_IMPL \
                and _span_receiver(node.func):
            yield _finding("torch-timing-discipline", mod, node,
                           "bare Span.start(); use 'with trace.span(...) as sp:'")


_TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                      "torch.random.seed", "torch.cuda.manual_seed",
                      "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all"}
_TORCH_SAMPLERS = {f"torch.{f}" for f in ("rand", "randn", "randint", "randperm", "normal",
                                          "bernoulli", "multinomial")}


def torch_rng_discipline(mod, project):
    imports = ImportMap(mod.tree)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        q = imports.qualified(node.func) or ""
        if q.startswith("numpy.random.") and q.split(".")[-1] not in _RNG_OK:
            yield _finding("torch-rng-discipline", mod, node,
                           f"{q}() draws from numpy's global RNG state; thread a "
                           f"np.random.default_rng(seed) Generator")
        elif q in _TORCH_GLOBAL_SEED:
            yield _finding("torch-rng-discipline", mod, node,
                           f"{q}() sets torch's global generator; seed a torch.Generator "
                           f"and pass it down")
        elif q in _TORCH_SAMPLERS and not any(k.arg == "generator" for k in node.keywords):
            yield _finding("torch-rng-discipline", mod, node,
                           f"{q}() without generator= draws from torch's global generator")


_BITID_IMPL = {f"{PORT}/core/{f}" for f in ("allreduce.py", "agg.py", "bucketer.py")}
_RAW_COLLECTIVES = {"torch.distributed.all_reduce", "torch.distributed.reduce_scatter_tensor"}
_ORDER_SENSITIVE = {"torch.sum", "torch.mean"}


def torch_bit_identity(mod, project):
    if mod.rel in _BITID_IMPL:
        return
    imports = ImportMap(mod.tree)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        q = imports.qualified(node.func)
        if q in _RAW_COLLECTIVES:
            yield _finding("torch-bit-identity", mod, node,
                           f"raw {q.split('.')[-1]}() outside the aggregation implementation; "
                           f"reduce through Aggregator.allreduce[_tree]")
            continue
        if q in _ORDER_SENSITIVE and node.args:
            name = dotted(node.args[0])
        elif isinstance(node.func, ast.Attribute) and node.func.attr in ("sum", "mean"):
            name = dotted(node.func.value)
        else:
            continue
        if name and _WORKER_NAME.search(name):
            yield _finding("torch-bit-identity", mod, node,
                           f"a sum or mean over {name} (a logical-worker-stacked value) "
                           f"follows the reduction's grouping; fold it in a fixed order "
                           f"or reduce through the Aggregator")


class _PortTree:
    """The reference mirror rule's anchors (``src/repro/...``) read from the
    port's tree, whose layout is the same; its oracle check is replaced by
    the port's own (below)."""

    def __init__(self, project):
        self.project = project

    def module_rel(self, rel):
        if rel == mirror.KERNEL_REF:
            return None
        return self.project.module_rel(PORT + rel[len("src/repro"):])


def _uses(mod, names):
    """The names of ``repro_torch.switchsim`` that ``mod`` reads."""
    imports = ImportMap(mod.tree)
    seen = {imports.qualified(n) for n in ast.walk(mod.tree)
            if isinstance(n, (ast.Name, ast.Attribute))}
    return [n for n in names if f"repro_torch.switchsim.{n}" in seen]


def torch_mirror_parity(project):
    for f in mirror.mirror_parity(_PortTree(project)):
        yield dataclasses.replace(f, rule="torch-mirror-parity")
    for rel, names in ((f"{PORT}/switchsim/dataplane.py", mirror.SHARED_CONSTS),
                       (f"{PORT}/core/switch.py", ("COUNTERS",))):
        mod = project.module_rel(rel)
        if mod is None:
            continue
        for name in set(names) - set(_uses(mod, names)):
            yield Finding("torch-mirror-parity", mod.rel, 1, 0,
                          f"{name} is not read from repro_torch.switchsim here; the "
                          f"dataplanes share the one definition")
    ref = project.module_rel(f"{PORT}/kernels/ref.py")
    if ref is None:
        return
    kernels = set()
    for path in sorted((project.root / PORT / "kernels").glob("fpisa_*.py")):
        mod = project.module(path)
        kernels |= set(mirror._top_defs(mod.tree)) if mod is not None else set()
    for name, node in mirror._top_defs(ref.tree).items():
        base = name[:-len("_ref")]
        if name.endswith("_ref") and not {base, f"fpisa_{base}"} & kernels:
            yield Finding("torch-mirror-parity", ref.rel, node.lineno, node.col_offset,
                          f"oracle {name}() has no kernel {base}() or fpisa_{base}() in "
                          f"kernels/fpisa_*.py")


PORT_RULES = {
    "torch-exact-scale": (torch_exact_scale, dict(
        scope=(f"{PORT}/core/*", f"{PORT}/kernels/*"),
        description="no torch.exp2 / ldexp / float 2**e on the port's scale paths")),
    "torch-timing-discipline": (torch_timing_discipline, dict(
        scope=_TIMING_SCOPE,
        description="no time.time() and no bare Span.start() on the port's phase paths")),
    "torch-rng-discipline": (torch_rng_discipline, dict(
        scope=(f"{PORT}/*",),
        description="no np.random global state and no torch global generator in the port")),
    "torch-bit-identity": (torch_bit_identity, dict(
        scope=(f"{PORT}/*",),
        description="no raw collectives or stacked-axis sums outside the port's aggregation")),
    "torch-mirror-parity": (torch_mirror_parity, dict(
        project=True,
        description="the port's dataplanes, numpy mirrors and kernel oracles stay in sync")),
}


@pytest.fixture
def port_rules():
    """Registers the port's rules for one test and removes them after it."""
    for name, (fn, kw) in PORT_RULES.items():
        register_rule(name, **kw)(fn)
    try:
        yield tuple(PORT_RULES)
    finally:
        for name in PORT_RULES:
            unregister_rule(name)


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------


def lint(root: Path, rule: str):
    return run_lint(["src"], root=root, rules=[rule])


def lines(result, rule, rel):
    return sorted(f.line for f in result.findings if f.rule == rule and f.path == rel)


def test_no_port_rule_outside_the_fixture():
    assert not set(PORT_RULES) & set(available_rules())


# ---------------------------------------------------------------------------
# torch-exact-scale
# ---------------------------------------------------------------------------


def test_exact_scale_fires(tmp_path, port_rules):
    rel = f"{PORT}/core/scale.py"
    write_tree(tmp_path, {rel: """\
        import math
        import torch
        from torch import ldexp

        def rescale(x, k, e):
            a = x * torch.exp2(k)
            b = ldexp(x, k)
            c = x * torch.pow(2, k) * math.pow(2, e) * math.exp2(e)
            d = x * 2 ** e + x * 2.0 ** (e - 1)
            return torch.float_power(x, 2) + a + b + c + d
    """})
    res = lint(tmp_path, "torch-exact-scale")
    assert lines(res, "torch-exact-scale", rel) == [6, 7, 8, 8, 8, 9, 9, 10]


def test_exact_scale_clean_and_scope(tmp_path, port_rules):
    write_tree(tmp_path, {
        f"{PORT}/core/numerics.py": """\
            import torch

            def f32_to_int32(x):
                hi = x >= 2.0**31
                out = torch.where(hi, 2**31 - 1, x.to(torch.int32))
                return torch.where(x < -(2**31), -(2**31), out) * 2 ** -3 + x.pow(2)
        """,
        # out of scope: the models may use any power
        f"{PORT}/models/rope.py": """\
            import torch

            def angles(e):
                return torch.exp2(e) * 2 ** e
        """,
    })
    assert lint(tmp_path, "torch-exact-scale").findings == []


# ---------------------------------------------------------------------------
# torch-timing-discipline
# ---------------------------------------------------------------------------


def test_timing_discipline_fires(tmp_path, port_rules):
    rel = f"{PORT}/serve/engine.py"
    write_tree(tmp_path, {rel: """\
        import time
        from time import time as now
        from repro_torch import trace

        def run(fn):
            t0 = time.time()
            fn()
            dt = now() - t0
            sp = trace.span("serve.step")
            sp.start()
            fn()
            sp.end()
            trace.span("chained").start()
            return dt
    """})
    res = lint(tmp_path, "torch-timing-discipline")
    assert lines(res, "torch-timing-discipline", rel) == [6, 8, 10, 13]


def test_timing_discipline_clean_scope_and_tracer(tmp_path, port_rules):
    write_tree(tmp_path, {
        f"{PORT}/launch/train.py": """\
            import threading
            from time import perf_counter
            from repro_torch import trace

            def step(fn):
                t0 = perf_counter()
                with trace.span("train.step") as sp:
                    sp.sync(fn())
                t = threading.Thread(target=fn)
                t.start()
                return perf_counter() - t0
        """,
        # out of scope: a data pipeline is not a phase path
        f"{PORT}/data/pipeline.py": """\
            import time

            def stamp():
                return time.time()
        """,
        # the tracer defines Span.start/end: the one legitimate caller
        f"{PORT}/trace/tracer.py": """\
            class Span:
                def __enter__(self):
                    span = self
                    return span.start()
        """,
    })
    assert lint(tmp_path, "torch-timing-discipline").findings == []


# ---------------------------------------------------------------------------
# torch-rng-discipline
# ---------------------------------------------------------------------------


def test_rng_discipline_fires(tmp_path, port_rules):
    rel = f"{PORT}/data/gen.py"
    write_tree(tmp_path, {rel: """\
        import numpy as np
        import torch
        from numpy.random import rand

        np.random.seed(0)
        x = np.random.normal(size=8) + rand(3)
        torch.manual_seed(0)
        torch.cuda.manual_seed_all(0)
        y = torch.randn(4) + torch.rand(4) + torch.normal(0.0, 1.0, (4,))
        z = torch.randint(0, 9, (4,)) + torch.randperm(4)
        w = torch.multinomial(y.abs(), 2) + torch.bernoulli(y.sigmoid())
    """})
    res = lint(tmp_path, "torch-rng-discipline")
    assert lines(res, "torch-rng-discipline", rel) == [5, 6, 6, 7, 8, 9, 9, 9, 10, 10, 11, 11]


def test_rng_discipline_clean(tmp_path, port_rules):
    write_tree(tmp_path, {f"{PORT}/models/registry.py": """\
        import numpy as np
        import torch

        rng = np.random.default_rng(np.random.SeedSequence([1, 2]))
        gen = torch.Generator()
        gen.manual_seed(0)
        x = torch.randn((4,), generator=gen) + torch.rand(4, generator=gen)
        p = torch.randperm(4, generator=gen)
        y = rng.normal(size=8)
    """})
    assert lint(tmp_path, "torch-rng-discipline").findings == []


# ---------------------------------------------------------------------------
# torch-bit-identity
# ---------------------------------------------------------------------------


def test_bit_identity_fires(tmp_path, port_rules):
    rel = f"{PORT}/train/step.py"
    write_tree(tmp_path, {rel: """\
        import torch
        import torch.distributed as dist
        from torch.distributed import reduce_scatter_tensor

        def step(loss, grads, worker_losses, stacked, out, group):
            dist.all_reduce(loss, group=group)
            reduce_scatter_tensor(out, grads, group=group)
            total = torch.sum(worker_losses) + torch.mean(stacked, 0)
            return total + worker_losses.sum() + stacked.mean(0)
    """})
    res = lint(tmp_path, "torch-bit-identity")
    assert lines(res, "torch-bit-identity", rel) == [6, 7, 8, 8, 9, 9]


def test_bit_identity_clean_suppressed_and_implementation(tmp_path, port_rules):
    write_tree(tmp_path, {
        f"{PORT}/train/step.py": """\
            import torch
            import torch.distributed as dist

            def step(loss, grads, losses_fold, group):
                # the reported scalar loss, not a gradient
                # repro-lint: disable=torch-bit-identity
                dist.all_reduce(loss, group=group)
                acc = torch.zeros(())
                for v in losses_fold.tolist():
                    acc = acc + v
                return torch.sum(grads[0]) + grads[1].mean() + acc
        """,
        # the aggregation implementation: raw collectives are the point
        f"{PORT}/core/allreduce.py": """\
            import torch.distributed as dist

            def native(x, stacked, group):
                dist.all_reduce(x, group=group)
                return stacked.sum(0)
        """,
    })
    res = lint(tmp_path, "torch-bit-identity")
    assert res.findings == [] and len(res.suppressed) == 1


# ---------------------------------------------------------------------------
# torch-mirror-parity
# ---------------------------------------------------------------------------

CLEAN_MIRROR = {
    f"{PORT}/switchsim/__init__.py": """\
        COUNTERS = ("packets", "duplicates")
        SLOT_STATE_FIELDS = ("exp", "man")
    """,
    f"{PORT}/switchsim/dataplane.py": """\
        from typing import NamedTuple
        from repro_torch.switchsim import COUNTERS, SLOT_STATE_FIELDS

        class DataplaneState(NamedTuple):
            exp: int
            man: int

        _I_PACKETS, _I_DUP = range(len(COUNTERS))
        _LOTTERY_MOD = 65521

        class BatchedDataplane:
            @property
            def stats(self):
                return dict(zip(COUNTERS, self.counters))

        class NumpyDataplane:
            def __init__(self, cfg):
                self._exp = 0
                self._man = 0
                assert all(hasattr(self, f"_{f}") for f in SLOT_STATE_FIELDS)
    """,
    f"{PORT}/core/switch.py": """\
        from repro_torch import switchsim

        def stats(s):
            return {k: s[k] for k in switchsim.COUNTERS}
    """,
    f"{PORT}/switchsim/npfpisa.py": """\
        EXP_BITS, MAN_BITS, BIAS = 8, 23, 127

        def encode(x): pass
        def renormalize(e, m): pass
        def fpisa_a_add(ae, am, ie, im): pass
        def fpisa_add_full(ae, am, ie, im): pass
    """,
    f"{PORT}/core/fpisa.py": """\
        def encode(x, fmt=None): pass
        def renormalize(p, fmt=None): pass
        def decode(p, fmt=None): pass
        def fpisa_a_add(acc, inp, fmt=None): pass
        def fpisa_add_full(acc, inp, fmt=None): pass
    """,
    f"{PORT}/core/numerics.py": """\
        FP32 = FpFormat("fp32", exp_bits=8, man_bits=23)
    """,
    f"{PORT}/kernels/ref.py": """\
        def extract_ref(x): pass
        def fused_encode_align_ref(x): pass
        def accum_ref(x): pass
    """,
    f"{PORT}/kernels/fpisa_fused.py": """\
        def fused_encode_align(x): pass
    """,
    f"{PORT}/kernels/fpisa_encode.py": """\
        def fpisa_extract(x): pass
    """,
    f"{PORT}/kernels/fpisa_accum.py": """\
        def fpisa_accum(x): pass
    """,
}


def test_mirror_parity_clean(tmp_path, port_rules):
    write_tree(tmp_path, CLEAN_MIRROR)
    assert lint(tmp_path, "torch-mirror-parity").findings == []


DRIFTS = {
    # a counter index added on one side only
    "counter": (f"{PORT}/switchsim/dataplane.py", "_I_PACKETS, _I_DUP = range(len(COUNTERS))",
                "_I_PACKETS, _I_DUP, _I_NEW = range(3)", [8]),
    # the dataplane's own copy of the counters
    "literal": (f"{PORT}/switchsim/dataplane.py",
                "from repro_torch.switchsim import COUNTERS, SLOT_STATE_FIELDS",
                'from repro_torch.switchsim import SLOT_STATE_FIELDS\n'
                'COUNTERS = ("packets", "duplicates")', [1, 3]),
    # a slot field the batched dataplane has and the numpy mirror lacks
    "field": (f"{PORT}/switchsim/dataplane.py", "        self._man = 0\n", "", [17]),
    # the switch shim's own counter names
    "switch": (f"{PORT}/core/switch.py", "switchsim.COUNTERS", '("packets", "duplicates")',
               [1]),
    # a mirror function missing from the numpy twin
    "function": (f"{PORT}/switchsim/npfpisa.py", "def fpisa_add_full(ae, am, ie, im): pass\n",
                 "", [1]),
    # the numpy mirror's wire constants off the format
    "wire": (f"{PORT}/switchsim/npfpisa.py", "8, 23, 127", "8, 22, 127", [1]),
    # a second home for the lottery constants
    "lottery": (f"{PORT}/switchsim/npfpisa.py", "EXP_BITS, MAN_BITS, BIAS = 8, 23, 127",
                "EXP_BITS, MAN_BITS, BIAS = 8, 23, 127\n_LOTTERY_MOD = 65521", [2]),
    # an oracle whose kernel is gone
    "oracle": (f"{PORT}/kernels/fpisa_accum.py", "def fpisa_accum(x): pass", "", [3]),
}


@pytest.mark.parametrize("drift", list(DRIFTS))
def test_mirror_parity_fires(tmp_path, port_rules, drift):
    rel, old, new, want = DRIFTS[drift]
    files = dict(CLEAN_MIRROR)
    src = textwrap.dedent(files[rel])
    assert old in src
    files[rel] = src.replace(old, new)
    write_tree(tmp_path, files)
    res = lint(tmp_path, "torch-mirror-parity")
    where = f"{PORT}/kernels/ref.py" if drift == "oracle" else rel
    assert lines(res, "torch-mirror-parity", where) == want, res.findings


# ---------------------------------------------------------------------------
# the port itself
# ---------------------------------------------------------------------------


def test_port_lints_clean(port_rules):
    """The port has no unsuppressed finding under any port rule; the only
    suppressions are the raw collectives that are not gradient aggregation."""
    res = run_lint([PORT], root=REPO_ROOT, rules=list(port_rules))
    assert res.errors == []
    assert res.findings == [], "\n".join(f"{f.path}:{f.line}: {f.rule}: {f.message}"
                                         for f in res.findings)
    assert {(f.rule, f.path) for f in res.suppressed} == {
        ("torch-bit-identity", f"{PORT}/train/step.py"),
        ("torch-bit-identity", f"{PORT}/train/pipeline.py")}
    assert res.checked > 80
