"""The port's Aggregator (repro_torch.core.agg) against the JAX Aggregator
inside shard_map, over W in {1, 2, 4} workers x strategy x wire_bits x
format, on ragged leaf sizes.

The JAX side runs once per W in a subprocess with W host devices
(tests/conftest.py::run_with_devices). The torch side runs W gloo processes
per W (file:// rendezvous under tmp_path, so parallel test workers never
share a port). All of them start together and write .npz files to tmp_path.

* fpisa and switchml: BIT-IDENTICAL to the reference (integer views), on the
  reference formulation (backend "torch") and on the kernel path's
  composition (local-max align + residual shift + fused decode, the code the
  "cuda" backend runs, here through the plain versions on CPU tensors).
  (fpisa_seq and switch_emu run through the same harness in
  tests/test_torch_switch.py.)
* native (a float SUM): the reduction order differs between gloo and XLA,
  so it is held to |torch - jax| <= 4 * 2^-23 * sum_i |x_i| elementwise (a
  few float32 roundings of the partial sums); at W <= 2 it is exact.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import allreduce as jar  # noqa: E402
from repro.core import fpisa as jf  # noqa: E402
from repro_torch.core import agg as tagg  # noqa: E402
from repro_torch.core import allreduce as tar  # noqa: E402
from repro_torch.core import fpisa as tf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = [1, 2, 4]
FMTS = ["fp32", "fp16", "bf16"]
WIRES = [32, 16, 8]
LEAVES = {"a": (37,), "b": (5, 130), "c": (300,), "d": (2, 256)}
COMBOS = ([("native", 32, "fp32")]
          + [(s, w, f) for s in ("switchml", "fpisa") for w in WIRES for f in FMTS])


def _name(strategy, wire, fmt):
    return f"{strategy}-w{wire}-{fmt}"


JAX_CODE = """
import numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.agg import AggConfig, Aggregator
W, COMBOS = {w}, {combos!r}
inp = dict(np.load({inp!r}))
mesh = compat.make_mesh((W,), ("data",), devices=jax.devices()[:W])
def f(tree):
    tree = {{k: v[0] for k, v in tree.items()}}
    return {{f"{{s}}-w{{w}}-{{fm}}": Aggregator(
        AggConfig(strategy=s, wire_bits=w, fmt_name=fm, backend="jnp"),
        ("data",)).allreduce_tree(tree) for s, w, fm in COMBOS}}
fn = jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(P("data"),),
                              out_specs=P(), axis_names={{"data"}}))
out = fn(inp)
np.savez({out!r}, **{{f"{{c}}/{{k}}": np.asarray(v)
                      for c, t in out.items() for k, v in t.items()}})
"""

TORCH_CODE = """
import os, numpy as np, torch, torch.distributed as dist
from repro_torch.core import allreduce
from repro_torch.core.agg import AggConfig, Aggregator
rank, W = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
if W > 1:
    dist.init_process_group("gloo", init_method={init!r}, rank=rank, world_size=W)
inp = np.load({inp!r})
tree = {{k: torch.from_numpy(inp[k][rank]) for k in inp.files}}
res = {{}}
for s, w, fm in {combos!r}:
    cfg = AggConfig(strategy=s, wire_bits=w, fmt_name=fm, backend="torch")
    for k, v in Aggregator(cfg).allreduce_tree(tree).items():
        res[f"{{s}}-w{{w}}-{{fm}}/{{k}}"] = v.numpy()
# the cuda backend's composition (ops wrappers -> plain versions on CPU)
allreduce.resolve_backend = lambda backend, device: "cuda"
for s, w, fm in {combos!r}:
    if s in ("fpisa", "fpisa_seq"):
        cfg = AggConfig(strategy=s, wire_bits=w, fmt_name=fm)
        for k, v in Aggregator(cfg).allreduce_tree(tree).items():
            res[f"cuda-{{s}}-w{{w}}-{{fm}}/{{k}}"] = v.numpy()
np.savez(os.environ["OUT"], **res)
if W > 1:
    dist.destroy_process_group()
"""


def run_worlds(tmp, combos, multi_device_runner, seed):
    """Every (strategy, wire_bits, fmt) of ``combos`` over W in WORLDS, on
    the JAX Aggregator and on the port's (backend "torch", and the cuda
    backend's composition as ``cuda-<strategy>-...`` for fpisa and
    fpisa_seq). Returns {W: (jax results, [torch results of each rank],
    inputs)}; every process of every W runs concurrently."""
    rng = np.random.default_rng(seed)
    procs, jax_runs, plan = [], [], {}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    pool = ThreadPoolExecutor(len(WORLDS))
    for w in WORLDS:
        inp = {k: (rng.standard_normal((w, *s)) * np.exp2(rng.integers(-6, 7, (w, *s))))
               .astype(np.float32) for k, s in LEAVES.items()}
        inp["a"][:, :3] = 0.0  # an all-zero run inside a block
        ipath = str(tmp / f"in{w}.npz")
        np.savez(ipath, **inp)
        jpath = str(tmp / f"jax{w}.npz")
        jax_runs.append(pool.submit(
            multi_device_runner, JAX_CODE.format(w=w, combos=combos, inp=ipath, out=jpath),
            n_devices=w, timeout=300))
        tpaths = [str(tmp / f"torch{w}_{r}.npz") for r in range(w)]
        code = TORCH_CODE.format(init=f"file://{tmp}/pg{w}", inp=ipath, combos=combos)
        for r in range(w):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=dict(env, RANK=str(r), WORLD_SIZE=str(w), OUT=tpaths[r])))
        plan[w] = (jpath, tpaths, inp)
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
        for r in jax_runs:
            r.result()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        pool.shutdown()
    return {w: (dict(np.load(j)), [dict(np.load(t)) for t in ts], inp)
            for w, (j, ts, inp) in plan.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, multi_device_runner):
    return run_worlds(tmp_path_factory.mktemp("agg"), COMBOS, multi_device_runner, 2024)


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


INT_CASES = [(w, s, wire, f) for w in WORLDS for s, wire, f in COMBOS if s != "native"]


@pytest.mark.parametrize("world,strategy,wire,fmt", INT_CASES,
                         ids=[f"W{w}-{_name(s, b, f)}" for w, s, b, f in INT_CASES])
def test_integer_strategies_bit_identical(runs, world, strategy, wire, fmt):
    jax_out, torch_ranks, _ = runs[world]
    name = _name(strategy, wire, fmt)
    for rank, res in enumerate(torch_ranks):
        for leaf, shape in LEAVES.items():
            got, want = res[f"{name}/{leaf}"], jax_out[f"{name}/{leaf}"]
            assert got.shape == want.shape == shape and got.dtype == np.float32
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"rank {rank} {leaf}")


FUSED_CASES = [(w, wire, f) for w in WORLDS for wire in WIRES for f in FMTS]


@pytest.mark.parametrize("world,wire,fmt", FUSED_CASES,
                         ids=[f"W{w}-w{b}-{f}" for w, b, f in FUSED_CASES])
def test_kernel_path_composition_bit_identical(runs, world, wire, fmt):
    jax_out, torch_ranks, _ = runs[world]
    for res in torch_ranks:
        for leaf in LEAVES:
            np.testing.assert_array_equal(
                _bits(res[f"cuda-fpisa-w{wire}-{fmt}/{leaf}"]),
                _bits(jax_out[f"{_name('fpisa', wire, fmt)}/{leaf}"]))


@pytest.mark.parametrize("world", WORLDS)
def test_native_within_stated_tolerance(runs, world):
    jax_out, torch_ranks, inp = runs[world]
    name = _name("native", 32, "fp32")
    for res in torch_ranks:
        for leaf in LEAVES:
            got, want = res[f"{name}/{leaf}"], jax_out[f"{name}/{leaf}"]
            bound = 4 * 2.0**-23 * np.abs(inp[leaf]).sum(axis=0)
            assert np.all(np.abs(got - want) <= bound)
            if world <= 2:
                np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("wire", [8, 16, 32])
def test_wire_shift_and_its_refusal_match(fmt, wire):
    """_wire_shift agrees with the reference wherever it is defined, and
    refuses (ValueError) exactly where the reference refuses: past
    W = 2^(wire-1) workers. In-process, no collective."""
    limit = 1 << (wire - 1) if wire < 32 else 1 << 20
    for w in [1, 2, 3, 4, 7, 8, 64, 100, limit - 1, limit, limit + 1, 4 * limit]:
        try:
            want = jar._wire_shift(jf.FORMATS[fmt], w, wire)
        except ValueError as e:
            with pytest.raises(ValueError, match="cannot carry a"):
                tar._wire_shift(tf.FORMATS[fmt], w, wire)
            assert wire < 32 and w > limit, e
            continue
        assert tar._wire_shift(tf.FORMATS[fmt], w, wire) == want


def test_sixteen_bit_wire_travels_as_int32():
    """No int16 SUM exists on gloo or NCCL: the 16-bit wire plane goes onto
    the collective as int32 values (same values; see core/allreduce.py)."""
    man = torch.tensor([-32768, -1, 0, 32767], dtype=torch.int32)
    wire = tar._wire_cast(man, 16)
    assert wire.dtype == torch.int16
    carried = tar._psum_wire(wire, None)
    assert carried.dtype == torch.int32
    assert torch.equal(carried, man)


def test_backend_names_and_cuda_on_cpu_refused():
    assert tagg.resolve_backend("auto", torch.device("cpu")) == "torch"
    assert tagg.resolve_backend("auto", torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="did you mean 'torch'"):
        tagg.AggConfig(backend="torh")
    agg = tagg.Aggregator(tagg.AggConfig(backend="cuda"))
    with pytest.raises(ValueError, match="takes CUDA tensors only"):
        agg.allreduce(torch.ones(256))


def _bucketed_stacked():
    from repro_torch.core import bucketer

    out = bucketer.bucketed_stacked_allreduce_tree({"a": torch.ones(2, 4)}, None,
                                                   tagg.AggConfig(bucket_bytes=1024))
    assert torch.equal(out["a"], torch.full((4,), 2.0))


def _logical_workers():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build
    from repro_torch.optim import optimizers
    from repro_torch.train.step import make_train_step

    model = build(get_smoke_config("qwen1.5-0.5b"), device=torch.device("cpu"))
    make_train_step(model, tagg.AggConfig(), optimizers.OptConfig(), 4, logical_workers=4)


@pytest.mark.parametrize("kwargs", [
    dict(stacked=True),
    dict(stacked=True, cfg=dict(strategy="fpisa_seq")),
    dict(cfg=dict(strategy="switch_emu", switch_shared="pool", switch_jobs=2)),
    dict(call=_bucketed_stacked), dict(call=_logical_workers),
], ids=["stacked", "fpisa_seq", "switch_emu", "bucketed_stacked", "logical_workers"])
def test_unported_capabilities_refused_at_construction(kwargs):
    """Nothing here is refused any more: stacked aggregation (the stacked
    strategies, the bucketed stacked tree and the train step's
    ``logical_workers``) and switch_emu on a shared multi-tenant dataplane
    are ported and build. tests/test_torch_stacked.py and
    tests/test_torch_switch.py hold them against the reference."""
    from repro_torch import switchsim

    if "call" in kwargs:
        kwargs["call"]()
    elif "switch_shared" in kwargs.get("cfg", {}):
        switchsim.reset_shared_dataplanes()
        try:
            agg = tagg.Aggregator(tagg.AggConfig(**kwargs["cfg"]))
            x = torch.arange(1.0, 301.0)
            assert not agg.stacked and torch.equal(agg.allreduce(x), x)
            dp = switchsim.shared_dataplane("pool", switchsim.DataplaneConfig(
                num_workers=1, num_jobs=2, job_workers=(1, 1)))
            assert dp.job_stats[0]["packets"] == 2  # 300 elements: 2 packets of 256
        finally:
            switchsim.reset_shared_dataplanes()
    else:
        cfg = tagg.AggConfig(**kwargs.pop("cfg", {}))
        agg = tagg.Aggregator(cfg, **kwargs)
        assert agg.stacked and agg.allreduce(torch.ones(3, 256)).shape == (256,)


def test_unknown_strategy_names_options():
    with pytest.raises(ValueError, match="did you mean 'fpisa'"):
        tagg.get_strategy("fpsa")
    with pytest.raises(ValueError, match="did you mean 'switch_emu'"):
        tagg.get_strategy("switch_emo")
    assert tagg.available_strategies() == (
        "fpisa", "fpisa_seq", "native", "switch_emu", "switchml")


def test_world_of_one_without_process_group():
    """No process group: the aggregator reduces over a world of one, and
    FPISA at W=1 is exact for normal fp32 values that share a block."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(1.0, 2.0, 300).astype(np.float32))
    out = tagg.Aggregator(tagg.AggConfig()).allreduce(x)
    assert tagg.world_size() == 1 and torch.equal(out, x)


def test_registry_roundtrip_register_construct_dispatch():
    """A strategy registered declaratively is dispatchable through the
    facade at once, and gone after ``unregister_strategy`` (the reference's
    plugin round trip, tests/test_agg.py)."""

    @tagg.register_strategy("_test_double", description="2x sum (test only)")
    def double_allreduce(x, group, cfg):
        return tar.native_allreduce(x, group, cfg) * 2.0

    try:
        assert "_test_double" in tagg.available_strategies()
        agg = tagg.Aggregator(tagg.AggConfig(strategy="_test_double"))
        x = torch.arange(8, dtype=torch.float32)
        np.testing.assert_array_equal(agg.allreduce(x).numpy(), np.arange(8) * 2.0)
        # ... and allreduce_tree reaches the same registered fn per leaf
        np.testing.assert_array_equal(agg.allreduce_tree({"a": x})["a"].numpy(),
                                      np.arange(8) * 2.0)
    finally:
        tagg.unregister_strategy("_test_double")
    assert "_test_double" not in tagg.available_strategies()
    tagg.unregister_strategy("_test_double")  # an unknown name is ignored


def test_duplicate_registration_refused():
    def fn(x, group, cfg):
        return x

    tagg.register_strategy("_test_dup")(fn)
    try:
        with pytest.raises(ValueError, match="already registered"):
            tagg.register_strategy("_test_dup")(fn)
        tagg.register_strategy("_test_dup", overwrite=True, description="wins")(fn)
        assert tagg.get_strategy("_test_dup").description == "wins"  # explicit wins
    finally:
        tagg.unregister_strategy("_test_dup")


@pytest.mark.parametrize("wire", [8, 16, 32])
def test_wire_capacity_guard_shared_with_pod_hop(wire):
    """The rail that guards the pod hop (``_hier_collect`` sums w_pod
    in-pod partials): 2^(wire-1) summands allowed, one more refused, a
    32-bit wire never refuses (the reference's tests/test_wire_edges.py)."""
    if wire >= 32:
        tar._check_wire_capacity(1 << 20, wire)
        return
    tar._check_wire_capacity(1 << (wire - 1), wire)
    with pytest.raises(ValueError, match="cannot carry"):
        tar._check_wire_capacity((1 << (wire - 1)) + 1, wire)
