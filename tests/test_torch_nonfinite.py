"""Non-finite inputs through the port's aggregation, against the JAX
reference: +-inf and NaN under ``switchml`` (XLA's float -> int32 convert:
NaN -> 0, +-inf saturate), and NaN staged to bf16 on every FPISA path
(XLA's float32 -> bf16 convert keeps a NaN's sign: 0x7FC0 / 0xFFC0).

* The two casts in process: ``numerics.f32_to_int32`` and
  ``fpisa.to_packed(.., "bf16")`` equal ``jnp.astype`` bit for bit on
  random raw words and on every special word.
* The Aggregator at W = 1, 2, 4 (gloo) against the JAX Aggregator inside
  shard_map (W host devices), all fed the same per-worker words: fp32
  leaves holding +-inf and quiet / signalling NaNs of both signs, and a
  bf16 leaf built from raw words (0x7FC0, 0xFFC0, 0x7F81, 0xFF81, +-inf),
  through ``switchml``, ``fpisa`` and ``fpisa_seq`` in fp32, fp16 and bf16;
  per leaf, bucketed, on the cuda backend's composition (the kernel
  wrappers' plain versions on CPU tensors), hierarchical over (pod, data)
  = (2, 2) at W = 4, and stacked: W = 4 logical workers at every placement
  (1, 2, 4 ranks) and k = 1, 2 on one rank, against the JAX stacked
  Aggregator. BIT-EXACT (integer views).
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import fpisa as tf  # noqa: E402
from repro_torch.core import numerics as nx  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FMTS = ["fp32", "fp16", "bf16"]
WORLDS = [1, 2, 4]
W = 4                       # rows of the input; logical workers of the stacked runs
BUCKET = 2048
F32_SPECIALS = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
                         0xFF800001, 0x7FA00000, 0xFFBFFFFF], np.uint32)
BF16_SPECIALS = np.array([0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7F81, 0xFF81], np.uint16)
COMBOS = [(f"{s}-{f}", dict(strategy=s, fmt_name=f))
          for s in ("switchml", "fpisa", "fpisa_seq") for f in FMTS]
HIER = [(f"hier-{s}-{f}", dict(strategy=s, fmt_name=f))
        for s in ("fpisa", "switchml") for f in FMTS]
STACKED = [(f"stacked-{s}-{f}", dict(strategy=s, fmt_name=f))
           for s in ("switchml", "fpisa", "fpisa_seq") for f in FMTS]


def _inputs(seed=31):
    """(W, ...) words per leaf: ``x`` float32 words, ``h`` bf16 words. Each
    worker holds specials at its own positions, in several blocks; one
    block holds only specials and zeros, and block 1 a special on every
    worker."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((W, 900)) * np.exp2(rng.integers(-8, 8, (W, 900))))
    x = x.astype(np.float32).view(np.uint32)
    for w in range(W):
        pos = rng.choice(900, 24, replace=False)
        x[w, pos] = rng.choice(F32_SPECIALS, 24)
        x[w, 256 + w] = F32_SPECIALS[w % len(F32_SPECIALS)]
    x[:, 512:768] = 0
    x[:, 512:520] = F32_SPECIALS
    h = (rng.standard_normal((W, 600)) * 4).astype(np.float32).view(np.uint32) >> 16
    h = h.astype(np.uint16)
    for w in range(W):
        pos = rng.choice(600, 16, replace=False)
        h[w, pos] = rng.choice(BF16_SPECIALS, 16)
    return {"x": x, "h": h}


JAX_CODE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.agg import AggConfig, Aggregator
w = {w}
inp = dict(np.load({inp!r}))
tree = {{"x": jnp.asarray(inp["x"]).view(jnp.float32),
         "h": jnp.asarray(inp["h"]).view(jnp.bfloat16)}}
res = {{}}
def save(tag, out):
    for c, t in out.items():
        for k, v in t.items():
            res[f"{{tag}}{{c}}/{{k}}"] = np.asarray(v.astype(jnp.float32))
def flat(mesh, axes, combos, rows):
    def f(t):
        t = {{k: v[0] for k, v in t.items()}}
        return {{n: Aggregator(AggConfig(backend="jnp", **kw), axes).allreduce_tree(t)
                 for n, kw in combos}}
    fn = jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(P(axes),), out_specs=P(),
                                  axis_names=set(axes)))
    return fn({{k: v[:rows] for k, v in tree.items()}})
save("", flat(compat.make_mesh((w,), ("data",), devices=jax.devices()[:w]), ("data",),
              {combos!r}, w))
if w == 4:
    save("", flat(compat.make_mesh((2, 2), ("pod", "data"), devices=jax.devices()[:4]),
                  ("pod", "data"), {hier!r}, 4))
if w == 1:
    mesh = compat.make_mesh((1,), ("data",), devices=jax.devices()[:1])
    for k in (1, 2, 4):
        def g(t):
            return {{n: Aggregator(AggConfig(backend="jnp", **kw), ("data",),
                                   stacked=True).allreduce_tree(t) for n, kw in {stacked!r}}}
        fn = jax.jit(compat.shard_map(g, mesh=mesh, in_specs=(P(),), out_specs=P(),
                                      axis_names={{"data"}}))
        save(f"k{{k}}-", fn({{n: v[:k] for n, v in tree.items()}}))
np.savez({out!r}, **res)
"""

TORCH_CODE = """
import os, numpy as np, torch, torch.distributed as dist
from repro_torch.core import agg as tagg, allreduce
from repro_torch.core.agg import AggConfig, Aggregator
from repro_torch.runtime.elastic import make_groups
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
if world > 1:
    dist.init_process_group("gloo", init_method={init!r}, rank=rank, world_size=world)
inp = np.load({inp!r})
full = {{"x": torch.from_numpy(inp["x"].view(np.int32)).view(torch.float32),
         "h": torch.from_numpy(inp["h"].view(np.int16)).view(torch.bfloat16)}}
res = {{}}
def run(tag, tree, combos, group=None, stacked=False, **extra):
    for name, kw in combos:
        out = Aggregator(AggConfig(**kw, **extra), group, stacked=stacked).allreduce_tree(tree)
        for k, v in out.items():
            res[f"{{tag}}{{name}}/{{k}}"] = v.to(torch.float32).numpy()
def everything(tag):
    mine = {{k: v[rank] for k, v in full.items()}}
    run(tag, mine, {combos!r})
    run(tag + "b-", mine, {combos!r}, bucket_bytes={bucket})
    k = {W} // world
    run(tag + f"k{W}-", {{n: v[rank * k:(rank + 1) * k] for n, v in full.items()}},
        {stacked!r}, stacked=True)
    if world == 1:
        for k in (1, 2):
            run(tag + f"k{{k}}-", {{n: v[:k] for n, v in full.items()}}, {stacked!r},
                stacked=True)
    if world == 4:
        run(tag, mine, {hier!r}, group=make_groups(2))
everything("")
cuda = lambda backend, device=None: backend if device is None else "cuda"
tagg.resolve_backend = allreduce.resolve_backend = cuda
everything("cuda-")
np.savez(os.environ["OUT"], **res)
if world > 1:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, multi_device_runner):
    """{world: (jax results, [torch results of each rank])}; every process
    of every world runs concurrently."""
    tmp = tmp_path_factory.mktemp("nonfinite")
    ipath = str(tmp / "in.npz")
    np.savez(ipath, **_inputs())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    pool = ThreadPoolExecutor(len(WORLDS))
    procs, jax_runs, plan = [], [], {}
    for w in WORLDS:
        jpath = str(tmp / f"jax{w}.npz")
        jax_runs.append(pool.submit(multi_device_runner, JAX_CODE.format(
            w=w, inp=ipath, out=jpath, combos=COMBOS, hier=HIER, stacked=STACKED),
            n_devices=w, timeout=300))
        code = TORCH_CODE.format(init=f"file://{tmp}/pg{w}", inp=ipath, combos=COMBOS,
                                 hier=HIER, stacked=STACKED, bucket=BUCKET, W=W)
        tpaths = [str(tmp / f"torch{w}_{r}.npz") for r in range(w)]
        for r in range(w):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=dict(env, RANK=str(r), WORLD_SIZE=str(w), OUT=tpaths[r])))
        plan[w] = (jpath, tpaths)
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
    return {w: (dict(np.load(j)), [dict(np.load(t)) for t in ts])
            for w, (j, ts) in plan.items()}


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# the casts in process
# ---------------------------------------------------------------------------


def test_f32_to_int32_is_xlas_convert():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    x = words.view(np.float32)
    x[:12] = [np.nan, -np.nan, np.inf, -np.inf, 2.0**31, -(2.0**31), 3e9, -3e9,
              2147483520.0, -2147483520.0, 0.5, -0.5]
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = nx.f32_to_int32(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[:4]) == [0, 0, 2**31 - 1, -(2**31)]


@pytest.mark.parametrize("src", ["fp32", "fp16"])
def test_bf16_cast_is_xlas_convert(src):
    rng = np.random.default_rng(1)
    if src == "fp32":
        words = rng.integers(0, 2**32, 400_000, dtype=np.uint64).astype(np.uint32)
        words[:len(F32_SPECIALS)] = F32_SPECIALS
        x = words.view(np.float32)
    else:
        x = np.arange(2**16, dtype=np.uint32).astype(np.uint16).view(np.float16)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    got = tf.to_packed(torch.from_numpy(x.copy()), "bf16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    if src == "fp32":  # the sign of each NaN survives; torch's own CPU cast loses it
        assert list(want[2:8]) == [0x7FC0, 0xFFC0, 0x7FC0, 0xFFC0, 0x7FC0, 0xFFC0]


# ---------------------------------------------------------------------------
# the Aggregator against JAX
# ---------------------------------------------------------------------------


def _cases():
    """(world, torch tag, name, JAX world, JAX tag): bucketed and
    cuda-composition results are held to the reference's per-leaf result
    (bucketing and the kernel path are bit-identical to it); stacked results
    to the JAX stacked Aggregator at the same k logical workers (its W = 1
    run)."""
    out = []
    for w in WORLDS:
        for cuda in ("", "cuda-"):
            kernel_path = ("fpisa", "fpisa_seq") if cuda else ("switchml", "fpisa", "fpisa_seq")
            names = [n for n, kw in COMBOS if kw["strategy"] in kernel_path]
            out += [(w, f"{cuda}{b}", n, w, "") for n in names for b in ("", "b-")]
            stacked = [n for n, kw in STACKED if kw["strategy"] in kernel_path]
            ks = (W, 1, 2) if w == 1 else (W,)
            out += [(w, f"{cuda}k{k}-", n, 1, f"k{k}-") for k in ks for n in stacked]
            if w == 4:
                out += [(w, cuda, n, w, "") for n, kw in HIER if kw["strategy"] in kernel_path]
    return out


CASES = _cases()


@pytest.mark.parametrize("world,tag,name,jax_world,jax_tag", CASES,
                         ids=[f"W{w}-{t}{n}" for w, t, n, _, _ in CASES])
def test_nonfinite_bit_identical_to_reference(runs, world, tag, name, jax_world, jax_tag):
    jax_out = runs[jax_world][0]
    for rank, res in enumerate(runs[world][1]):
        for leaf in ("x", "h"):
            got, want = res[f"{tag}{name}/{leaf}"], jax_out[f"{jax_tag}{name}/{leaf}"]
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"rank {rank} leaf {leaf}")


def test_the_inputs_reach_the_fixed_casts(runs):
    """The reference's results hold what the faults broke: +inf where a
    worker's +inf saturated (switchml), and bf16's +max where a positive
    NaN was staged to bf16 (fpisa)."""
    jax_out = runs[1][0]
    sw = jax_out["switchml-fp32/x"]
    assert np.isposinf(sw).any() and (sw == 0).any()
    fp = jax_out["fpisa-bf16/x"]
    bf16_max = np.float32(np.array([0x7F7F0000], np.uint32).view(np.float32)[0])
    assert (fp == bf16_max).any() and (fp == -bf16_max).any()
