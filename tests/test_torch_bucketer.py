"""The port's bucketer, chunked and hierarchical aggregation
(repro_torch.core.bucketer, core/agg.py, core/allreduce.py) against the JAX
reference.

* Plans: ``make_plan`` equals the reference's field for field on
  tests/test_bucketer.py's PLAN_CASES and its mixed-dtype case, fed the same
  leaf list (meta tensors on the port's side, ShapeDtypeStructs on the
  reference's); bad arguments raise the same errors.
* In process (a world of one): bucketed ``allreduce_tree`` equals the
  per-leaf one BIT FOR BIT over strategy x wire 32/16/8 x fp32/fp16/bf16, on
  ragged trees with a scalar, a bf16 leaf and an int32 (passthrough) leaf,
  on backend "torch" and on the cuda backend's composition (the kernel
  wrappers, their plain versions on CPU tensors); the same with a
  block-multiple ``chunk_elems``.
* Across ranks: W = 2 and 4 gloo ranks against the JAX Aggregator inside
  shard_map on W host devices, one spawn per W for every case below:
  bucketed flat aggregation (every strategy, wire and format), chunked
  per-leaf aggregation (block-multiple and ragged chunk sizes, and
  bucketed with the block-multiple one), and at W = 4 the 2 x 2
  hierarchical layout (``runtime.elastic.make_groups(2)``) at pod wire
  32/16/8, per leaf and bucketed with stripes, plus two flat strategies
  over the group pair. All BIT-EXACT (integer views), except native, which
  sums floats in another order and is held to the tolerance of
  tests/test_torch_agg.py, 4 ulps of the leaf's dtype times sum_i |x_i|.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bucketer as jb  # noqa: E402
from repro_torch.core import agg as tagg  # noqa: E402
from repro_torch.core import allreduce as tar  # noqa: E402
from repro_torch.core import bucketer as tb  # noqa: E402
from repro_torch.core.agg import AggConfig, Aggregator  # noqa: E402
from test_bucketer import PLAN_CASES  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FMTS = ["fp32", "fp16", "bf16"]
WIRES = [32, 16, 8]


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32, 2: np.int16}[a.dtype.itemsize])


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def _as_tuple(plan):
    return (plan.block, plan.bucket_elems, plan.passthrough,
            [(b.index, b.group, b.elems,
              [(s.leaf, s.start, s.size, s.span, s.offset) for s in b.segments])
             for b in plan.buckets])


MIXED = [((300,), "float32"), ((300,), "bfloat16"), ((300,), "float32"), ((8,), "int32")]
PLAN_LEAVES = ([[((n,), "float32") for n in sizes] for sizes, _, _ in PLAN_CASES]
               + [MIXED, MIXED,
                  [((37, 13), "float32"), ((), "float16"), ((5000,), "bfloat16"),
                   ((0, 4), "float32"), ((700,), "float16")]])
PLAN_ARGS = [(b, bb) for _, b, bb in PLAN_CASES] + [(256, 1 << 20), (128, 512), (64, 1024)]


@pytest.mark.parametrize("case", range(len(PLAN_LEAVES)))
def test_plan_equals_reference(case):
    spec = PLAN_LEAVES[case]
    block, bucket_bytes = PLAN_ARGS[case]
    ref = jb.make_plan([jax.ShapeDtypeStruct(s, jnp.dtype(d)) for s, d in spec],
                       block=block, bucket_bytes=bucket_bytes)
    got = tb.make_plan([torch.empty(s, dtype=getattr(torch, d), device="meta")
                        for s, d in spec], block=block, bucket_bytes=bucket_bytes)
    assert _as_tuple(got) == _as_tuple(ref)
    assert all(isinstance(b.group, str) and not b.group.startswith("torch")
               for b in got.buckets)


@pytest.mark.parametrize("block,bucket_bytes", [(0, 1024), (256, 0), (-1, 1024), (256, -4)])
def test_plan_rejects_bad_args_like_reference(block, bucket_bytes):
    with pytest.raises(ValueError) as want:
        jb.make_plan([jax.ShapeDtypeStruct((8,), jnp.float32)], block=block,
                     bucket_bytes=bucket_bytes)
    with pytest.raises(ValueError) as got:
        tb.make_plan([torch.empty(8, device="meta")], block=block, bucket_bytes=bucket_bytes)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# in process: bucketed == per-leaf, bit for bit
# ---------------------------------------------------------------------------

RAGGED = [
    {"a": (37, 13), "b": (5000,), "c": (), "d": (700,), "e": (1300,),
     "f": ("bf16", 400), "g": ("int32", 16)},
    {"a": (777,), "b": (1,), "c": (256,), "d": (255,), "e": (257,)},
    {"a": (12000,)},
]


def _tree(shapes, seed=0, scale=0.01):
    rng = np.random.default_rng(seed)
    tree = {}
    for k, s in shapes.items():
        if s and s[0] == "int32":
            tree[k] = torch.from_numpy(rng.integers(0, 100, s[1:]).astype(np.int32))
            continue
        dtype = torch.bfloat16 if s and s[0] == "bf16" else torch.float32
        shape = s[1:] if dtype == torch.bfloat16 else s
        x = rng.standard_normal(shape) * scale * np.exp2(rng.integers(-4, 5, shape))
        tree[k] = torch.from_numpy(np.asarray(x, np.float32)).to(dtype)
    return tree


def _equal_trees(a, b, what):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (what, k)
        va, vb = a[k].reshape(-1), b[k].reshape(-1)
        if va.is_floating_point():
            view = torch.int32 if va.element_size() == 4 else torch.int16
            va, vb = va.view(view), vb.view(view)
        assert torch.equal(va, vb), (what, k)


IN_PROCESS = ([("native", 32, "fp32"), ("switch_emu", 32, "fp32")]
              + [("switchml", 32, f) for f in FMTS]
              + [("fpisa_seq", 32, f) for f in FMTS]
              + [("fpisa", w, f) for w in WIRES for f in FMTS])


@pytest.fixture(params=["torch", "cuda-composition"])
def backend_path(request, monkeypatch):
    """The cuda backend's composition runs the kernel wrappers, which take
    their plain versions on CPU tensors."""
    if request.param != "torch":
        def as_cuda(backend, device=None):
            return backend if device is None else "cuda"

        monkeypatch.setattr(tagg, "resolve_backend", as_cuda)
        monkeypatch.setattr(tar, "resolve_backend", as_cuda)
    return request.param


@pytest.mark.parametrize("strategy,wire,fmt", IN_PROCESS,
                         ids=[f"{s}-w{w}-{f}" for s, w, f in IN_PROCESS])
def test_bucketed_equals_per_leaf_in_process(backend_path, strategy, wire, fmt):
    trees = RAGGED[1:2] if strategy == "switch_emu" else RAGGED
    for i, shapes in enumerate(trees):
        tree = _tree(shapes, seed=i)
        base = dict(strategy=strategy, wire_bits=wire, fmt_name=fmt)
        want = Aggregator(AggConfig(**base)).allreduce_tree(tree)
        for bucket_bytes in (2048, 8192, 1 << 20):
            got = Aggregator(AggConfig(bucket_bytes=bucket_bytes, **base)).allreduce_tree(tree)
            _equal_trees(got, want, (i, bucket_bytes))


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("fmt", FMTS)
def test_bucketed_chunked_equals_per_leaf_chunked(backend_path, wire, fmt):
    for i, shapes in enumerate(RAGGED):
        tree = _tree(shapes, seed=10 + i)
        base = dict(wire_bits=wire, fmt_name=fmt, chunk_elems=1024)
        want = Aggregator(AggConfig(**base)).allreduce_tree(tree)
        got = Aggregator(AggConfig(bucket_bytes=8192, **base)).allreduce_tree(tree)
        _equal_trees(got, want, i)


def test_bucketed_lists_keep_their_structure_and_order():
    leaves = list(_tree(RAGGED[1], seed=3).values())
    got = Aggregator(AggConfig(bucket_bytes=2048)).allreduce_tree(leaves)
    want = Aggregator(AggConfig()).allreduce_tree(leaves)
    assert isinstance(got, list) and len(got) == len(leaves)
    _equal_trees(dict(enumerate(got)), dict(enumerate(want)), "list")


def test_bucketing_and_chunking_construction_checks():
    with pytest.raises(ValueError, match="multiple of block"):
        Aggregator(AggConfig(bucket_bytes=4096, chunk_elems=1000))
    Aggregator(AggConfig(chunk_elems=1000))  # chunking alone needs no alignment
    with pytest.raises(ValueError, match="chunk_elems is not supported with stacked"):
        Aggregator(AggConfig(bucket_bytes=4096, chunk_elems=1024), stacked=True)
    out = tb.bucketed_stacked_allreduce_tree({"a": torch.ones(3, 4)}, None,
                                             AggConfig(bucket_bytes=1024))
    assert torch.equal(out["a"], torch.full((4,), 3.0))
    with pytest.raises(ValueError, match="pod_group, data_group"):
        Aggregator(AggConfig(), (None, None, None))


def test_pack_bucket_fills_one_buffer_and_zeroes_tails():
    leaves = [torch.arange(5, dtype=torch.float32) + 1, torch.arange(300, dtype=torch.float32)]
    plan = tb.make_plan(leaves, block=256, bucket_bytes=1 << 20)
    (bucket,) = plan.buckets
    buf = tb.pack_bucket(bucket, {i: l for i, l in enumerate(leaves)}, torch.float16, "cpu")
    assert buf.dtype == torch.float16 and buf.shape == (bucket.elems,) == (768,)
    assert torch.equal(buf[:300], leaves[1].half())          # last leaf first
    assert torch.equal(buf[300:512], torch.zeros(212, dtype=torch.float16))
    assert torch.equal(buf[512:517], leaves[0].half())
    assert not buf[517:].any()


# ---------------------------------------------------------------------------
# across ranks, against JAX shard_map
# ---------------------------------------------------------------------------

LEAVES = {"a": (37,), "b": (5, 130), "c": (300,), "d": (2, 256), "e": (640,)}
BF16 = ("e",)
BUCKET = 2048
FLAT = ([("native-w32-fp32", dict(strategy="native"))]
        + [(f"switchml-w32-{f}", dict(strategy="switchml", fmt_name=f)) for f in FMTS]
        + [(f"fpisa_seq-w32-{f}", dict(strategy="fpisa_seq", fmt_name=f)) for f in FMTS]
        + [(f"fpisa-w{w}-{f}", dict(strategy="fpisa", wire_bits=w, fmt_name=f))
           for w in WIRES for f in FMTS])
CHUNKED = [(f"{s}-chunk{c}-{f}", dict(strategy=s, chunk_elems=c, fmt_name=f))
           for s, c, f in [("fpisa", 256, "fp32"), ("fpisa", 512, "bf16"),
                           ("fpisa", 200, "fp32"), ("switchml", 256, "fp32"),
                           ("fpisa_seq", 384, "fp16")]]
HIER = ([(f"hier-fpisa-pod{p}-{f}", dict(strategy="fpisa", pod_wire_bits=p, fmt_name=f))
         for p in WIRES for f in ("fp32", "bf16")]
        + [("hier-fpisa-w16-pod8-fp32", dict(strategy="fpisa", wire_bits=16, pod_wire_bits=8)),
           ("hier-switchml-fp32", dict(strategy="switchml")),
           ("hier-fpisa_seq-fp32", dict(strategy="fpisa_seq"))])

JAX_CODE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.agg import AggConfig, Aggregator
W = {w}
inp = dict(np.load({inp!r}))
tree = {{k: jnp.asarray(v, jnp.bfloat16 if k in {bf16!r} else jnp.float32)
         for k, v in inp.items()}}
res = {{}}
def run(mesh, axes, combos):
    def f(t):
        t = {{k: v[0] for k, v in t.items()}}
        return {{name: Aggregator(AggConfig(backend="jnp", **kw), axes).allreduce_tree(t)
                 for name, kw in combos}}
    fn = jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(P(axes),), out_specs=P(),
                                  axis_names=set(axes)))
    for c, t in fn(tree).items():
        for k, v in t.items():
            res[f"{{c}}/{{k}}"] = np.asarray(v.astype(jnp.float32))
run(compat.make_mesh((W,), ("data",), devices=jax.devices()[:W]), ("data",),
    {flat!r} + {chunked!r})
if W == 4:
    run(compat.make_mesh((2, 2), ("pod", "data"), devices=jax.devices()[:4]),
        ("pod", "data"), {hier!r})
np.savez({out!r}, **res)
"""

TORCH_CODE = """
import os, numpy as np, torch, torch.distributed as dist
from repro_torch.core import agg as tagg, allreduce
from repro_torch.core.agg import AggConfig, Aggregator
from repro_torch.runtime.elastic import make_groups
rank, W = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method={init!r}, rank=rank, world_size=W)
inp = np.load({inp!r})
tree = {{k: torch.from_numpy(inp[k][rank]).to(torch.bfloat16 if k in {bf16!r} else torch.float32)
         for k in inp.files}}
res = {{}}
def run(tag, group, combos, **extra):
    for name, kw in combos:
        out = Aggregator(AggConfig(**kw, **extra), group).allreduce_tree(tree)
        for k, v in out.items():
            res[f"{{tag}}{{name}}/{{k}}"] = v.to(torch.float32).numpy()
pair = make_groups(2) if W == 4 else None
def everything(tag):
    run(tag + "b-", None, {flat!r}, bucket_bytes={bucket})
    run(tag + "c-", None, {chunked!r})
    run(tag + "cb-", None, [c for c in {chunked!r} if c[1]["chunk_elems"] % 256 == 0],
        bucket_bytes={bucket})
    if pair is not None:
        run(tag, pair, {hier!r})
        run(tag + "b-", pair, {hier!r}, bucket_bytes={bucket})
everything("")
# the cuda backend's composition (ops wrappers -> plain versions on CPU)
cuda = lambda backend, device=None: backend if device is None else "cuda"
tagg.resolve_backend = allreduce.resolve_backend = cuda
everything("cuda-")
np.savez(os.environ["OUT"], **res)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, multi_device_runner):
    """One spawn per W in (2, 4): the JAX run and W gloo ranks, all at once.
    Returns {W: (jax results, [torch results of each rank], inputs)}."""
    tmp = tmp_path_factory.mktemp("bucketer")
    rng = np.random.default_rng(13)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    fmt = dict(flat=FLAT, chunked=CHUNKED, hier=HIER, bf16=BF16)
    procs, jax_runs, plan = [], [], {}
    pool = ThreadPoolExecutor(2)
    for w in (2, 4):
        inp = {k: (rng.standard_normal((w, *s)) * np.exp2(rng.integers(-6, 7, (w, *s))))
               .astype(np.float32) for k, s in LEAVES.items()}
        inp["a"][:, :3] = 0.0
        for k in BF16:  # values a bf16 holds exactly on both sides
            inp[k] = torch.from_numpy(inp[k]).to(torch.bfloat16).float().numpy()
        ipath, jpath = str(tmp / f"in{w}.npz"), str(tmp / f"jax{w}.npz")
        np.savez(ipath, **inp)
        jax_runs.append(pool.submit(
            multi_device_runner, JAX_CODE.format(w=w, inp=ipath, out=jpath, **fmt),
            n_devices=w, timeout=400))
        code = TORCH_CODE.format(init=f"file://{tmp}/pg{w}", inp=ipath, bucket=BUCKET, **fmt)
        tpaths = [str(tmp / f"torch{w}_{r}.npz") for r in range(w)]
        for r in range(w):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=dict(env, RANK=str(r), WORLD_SIZE=str(w), OUT=tpaths[r])))
        plan[w] = (jpath, tpaths, inp)
    try:
        for p in procs:
            _, err = p.communicate(timeout=400)
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


def _check(ranks, world, got_tag, want_name, tol_inputs=None):
    jax_out, torch_ranks, inp = ranks[world]
    for rank, res in enumerate(torch_ranks):
        for leaf, shape in LEAVES.items():
            got, want = res[f"{got_tag}/{leaf}"], jax_out[f"{want_name}/{leaf}"]
            assert got.shape == want.shape == shape, (leaf, got.shape)
            if tol_inputs is None:
                np.testing.assert_array_equal(_bits(got), _bits(want),
                                              err_msg=f"rank {rank} {leaf}")
            else:
                ulp = 2.0**-7 if leaf in BF16 else 2.0**-23  # of the leaf's dtype
                bound = 4 * ulp * np.abs(tol_inputs[leaf]).sum(axis=0)
                assert np.all(np.abs(got - want) <= bound), (rank, leaf)


FLAT_CASES = [(w, name) for w in (2, 4) for name, _ in FLAT]


@pytest.mark.parametrize("world,name", FLAT_CASES, ids=[f"W{w}-{n}" for w, n in FLAT_CASES])
def test_bucketed_across_ranks_bit_identical(ranks, world, name):
    tol = ranks[world][2] if name.startswith("native") else None
    _check(ranks, world, f"b-{name}", name, tol)


FUSED = [(w, name) for w, name in FLAT_CASES if name.startswith("fpisa-")]


@pytest.mark.parametrize("world,name", FUSED, ids=[f"W{w}-{n}" for w, n in FUSED])
def test_bucketed_kernel_composition_across_ranks(ranks, world, name):
    _check(ranks, world, f"cuda-b-{name}", name)


CHUNK_CASES = [(w, name, tag) for w in (2, 4) for name, kw in CHUNKED
               for tag in (["c-", "cb-"] if kw["chunk_elems"] % 256 == 0 else ["c-"])]


@pytest.mark.parametrize("world,name,tag", CHUNK_CASES,
                         ids=[f"W{w}-{t}{n}" for w, n, t in CHUNK_CASES])
def test_chunked_across_ranks_equals_jax_chunked(ranks, world, name, tag):
    _check(ranks, world, f"{tag}{name}", name)


HIER_CASES = [(name, tag) for name, _ in HIER for tag in ("", "b-", "cuda-", "cuda-b-")
              if name.startswith("hier-fpisa-") or not tag.startswith("cuda")]


@pytest.mark.parametrize("name,tag", HIER_CASES, ids=[f"{t}{n}" for n, t in HIER_CASES])
def test_hierarchical_two_by_two_bit_identical(ranks, name, tag):
    """(pod, data) = (2, 2): per leaf (``""``), bucketed with stripes
    (``b-``), and the same on the cuda backend's composition."""
    _check(ranks, 4, f"{tag}{name}", name)
