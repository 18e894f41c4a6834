"""The port's stacked (logical-worker) aggregation and logical-worker train
step (core/allreduce.py stacked section, core/bucketer.py, train/step.py)
against the JAX reference.

* Every stacked strategy against the JAX ``Aggregator(stacked=True)`` inside
  shard_map (on one host device, k = 4 workers), both fed the same
  per-worker arrays made with numpy from a seed: switchml, fpisa, fpisa_seq
  over fp32/fp16/bf16 x wire 32/16/8, switch_emu (fp32) at each wire, and
  native. The port runs each at the three placements of W = 4 logical
  workers, (1 rank, k = 4), (2 ranks, k = 2) and (4 ranks, k = 1), over gloo,
  per leaf and bucketed, on backend "torch" and (fpisa, fpisa_seq) on the
  cuda backend's composition (the kernel wrappers, their plain versions on
  CPU tensors). All BIT-EXACT (integer views), except native, which sums
  floats in another order: |torch - jax| <= 4 ulps of the leaf's dtype x
  sum_i |x_i| (the bound of tests/test_torch_agg.py).
* Placement invariance: the three placements give the same bits.
* Bucketed stacked == per-leaf stacked in process on ragged trees.
* The logical-worker train step (smoke qwen1.5-0.5b, W = 4, 3 steps)
  against the reference's 1-device step with ``logical_workers=4``: loss
  within 2e-6 (step 0) / 2e-5 and grad norm within 2e-5, the tolerances of
  tests/test_torch_train.py; fed the reference's per-worker gradients, the
  two stacked aggregations are bit-exact.
* The loss folded over the gathered (W,) losses, and so the losses and
  weights of 3 steps, are bit-identical across the three placements.
* The reference's refusals, with its messages.
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
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.agg import AggConfig as JaxAggConfig  # noqa: E402
from repro.core.agg import Aggregator as JaxAggregator  # noqa: E402
from repro.data.pipeline import ShardedLoader as JaxLoader  # noqa: E402
from repro.data.pipeline import SyntheticCorpus as JaxCorpus  # noqa: E402
from repro.models.registry import build as jax_build  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro.runtime.elastic import make_mesh_for  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import agg as tagg  # noqa: E402
from repro_torch.core import allreduce as tar  # noqa: E402
from repro_torch.core.agg import AggConfig, Aggregator  # noqa: E402
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from test_torch_bucketer import RAGGED, _equal_trees, _tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FMTS = ["fp32", "fp16", "bf16"]
WIRES = [32, 16, 8]
W = 4                                   # logical workers
WORLDS = [1, 2, 4]                      # placements: ranks x (k = W / ranks)
LEAVES = {"a": (37,), "b": (5, 130), "c": (300,), "d": (2, 256), "e": (640,)}
BF16 = ("e",)
BUCKET = 2048
COMBOS = ([("native-w32-fp32", dict(strategy="native"))]
          + [(f"{s}-w{w}-{f}", dict(strategy=s, wire_bits=w, fmt_name=f))
             for s in ("switchml", "fpisa", "fpisa_seq") for w in WIRES for f in FMTS]
          + [(f"switch_emu-w{w}-fp32", dict(strategy="switch_emu", wire_bits=w))
             for w in WIRES])
KERNEL_PATH = [name for name, kw in COMBOS if kw["strategy"] in ("fpisa", "fpisa_seq")]
ARCH, BATCH, SEQ, STEPS = "qwen1.5-0.5b", 4, 64, 3


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32, 2: np.int16}[a.dtype.itemsize])


JAX_CODE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.agg import AggConfig, Aggregator
inp = dict(np.load({inp!r}))
tree = {{k: jnp.asarray(v, jnp.bfloat16 if k in {bf16!r} else jnp.float32)
         for k, v in inp.items()}}
mesh = compat.make_mesh((1,), ("data",), devices=jax.devices()[:1])
def f(t):
    return {{name: Aggregator(AggConfig(backend="jnp", **kw), ("data",),
                              stacked=True).allreduce_tree(t) for name, kw in {combos!r}}}
fn = jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(P(),), out_specs=P(),
                              axis_names={{"data"}}))
np.savez({out!r}, **{{f"{{c}}/{{k}}": np.asarray(v.astype(jnp.float32))
                      for c, t in fn(tree).items() for k, v in t.items()}})
"""

TORCH_CODE = """
import os, numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.core import agg as tagg, allreduce
from repro_torch.core.agg import AggConfig, Aggregator
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
from repro_torch.models.registry import build
from repro_torch.optim import optimizers
from repro_torch.train.step import make_train_step
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method={init!r}, rank=rank, world_size=world)
k = {w} // world
inp = np.load({inp!r})
tree = {{n: torch.from_numpy(inp[n][rank * k:(rank + 1) * k])
         .to(torch.bfloat16 if n in {bf16!r} else torch.float32) for n in inp.files}}
res = {{}}
def run(tag, combos):
    for name, kw in combos:
        for pre, extra in (("", {{}}), ("b-", {{"bucket_bytes": {bucket}}})):
            out = Aggregator(AggConfig(**kw, **extra), stacked=True).allreduce_tree(tree)
            for n, v in out.items():
                res[f"{{tag}}{{pre}}{{name}}/{{n}}"] = v.to(torch.float32).numpy()
run("", {combos!r})
# the logical-worker train step: smoke model, W workers, the rank's slice
cfg = get_smoke_config("qwen1.5-0.5b")
model = build(cfg, device=torch.device("cpu"), seed=0)
opt_cfg = optimizers.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
opt = optimizers.init(list(model.parameters()), opt_cfg)
step = make_train_step(model, AggConfig(strategy="fpisa", bucket_bytes={bucket}), opt_cfg,
                       {batch}, logical_workers={w})
loader = ShardedLoader(SyntheticCorpus(cfg.vocab_size, 0), {batch}, {seq})
local = {batch} // world
losses = []
for i in range({steps}):
    toks = loader.batch_at(i)["tokens"][rank * local:(rank + 1) * local]
    opt, metrics = step(opt, {{"tokens": torch.from_numpy(toks)}})
    losses.append(metrics["loss"].numpy())
res["train/losses"] = np.stack(losses)
res["train/params"] = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()
# the cuda backend's composition (ops wrappers -> plain versions on CPU)
tagg.resolve_backend = allreduce.resolve_backend = (
    lambda backend, device=None: backend if device is None else "cuda")
run("cuda-", [c for c in {combos!r} if c[0] in {kernel!r}])
np.savez(os.environ["OUT"], **res)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def placements(tmp_path_factory, multi_device_runner):
    """The JAX run (one device, k = W) and the port at every placement, all
    at once. Returns (jax results, {world: [results of each rank]},
    inputs)."""
    tmp = tmp_path_factory.mktemp("stacked")
    rng = np.random.default_rng(21)
    inp = {k: (rng.standard_normal((W, *s)) * np.exp2(rng.integers(-6, 7, (W, *s))))
           .astype(np.float32) for k, s in LEAVES.items()}
    inp["a"][:, :3] = 0.0  # an all-zero run inside a block
    for k in BF16:  # values a bf16 holds exactly on both sides
        inp[k] = torch.from_numpy(inp[k]).to(torch.bfloat16).float().numpy()
    ipath, jpath = str(tmp / "in.npz"), str(tmp / "jax.npz")
    np.savez(ipath, **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    pool = ThreadPoolExecutor(1)
    jax_run = pool.submit(multi_device_runner,
                          JAX_CODE.format(inp=ipath, out=jpath, combos=COMBOS, bf16=BF16),
                          n_devices=1, timeout=300)
    procs, paths = [], {}
    for world in WORLDS:
        code = TORCH_CODE.format(init=f"file://{tmp}/pg{world}", inp=ipath, w=W, bf16=BF16,
                                 bucket=BUCKET, combos=COMBOS, kernel=KERNEL_PATH,
                                 batch=BATCH, seq=SEQ, steps=STEPS)
        paths[world] = [str(tmp / f"torch{world}_{r}.npz") for r in range(world)]
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=dict(env, RANK=str(r), WORLD_SIZE=str(world), OUT=paths[world][r])))
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
        jax_run.result()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        pool.shutdown()
    return (dict(np.load(jpath)),
            {world: [dict(np.load(t)) for t in ts] for world, ts in paths.items()}, inp)


CASES = ([(world, tag, name) for world in WORLDS for tag in ("", "b-") for name, _ in COMBOS]
         + [(world, "cuda-" + tag, name) for world in WORLDS for tag in ("", "b-")
            for name in KERNEL_PATH])


@pytest.mark.parametrize("world,tag,name", CASES,
                         ids=[f"ranks{w}-{t}{n}" for w, t, n in CASES])
def test_stacked_matches_jax(placements, world, tag, name):
    jax_out, torch_worlds, inp = placements
    for rank, res in enumerate(torch_worlds[world]):
        for leaf, shape in LEAVES.items():
            got, want = res[f"{tag}{name}/{leaf}"], jax_out[f"{name}/{leaf}"]
            assert got.shape == want.shape == shape, (leaf, got.shape)
            if name.startswith("native"):
                ulp = 2.0**-7 if leaf in BF16 else 2.0**-23  # of the leaf's dtype
                bound = 4 * ulp * np.abs(inp[leaf]).sum(axis=0)
                assert np.all(np.abs(got - want) <= bound), (rank, leaf)
            else:
                np.testing.assert_array_equal(_bits(got), _bits(want),
                                              err_msg=f"rank {rank} {leaf}")


INVARIANT = [(tag, name) for tag in ("", "b-") for name, _ in COMBOS
             if not name.startswith("native")]


@pytest.mark.parametrize("tag,name", INVARIANT, ids=[f"{t}{n}" for t, n in INVARIANT])
def test_placement_invariance(placements, tag, name):
    """(1, 4), (2, 2) and (4, 1) give the same bits on every rank."""
    _, torch_worlds, _ = placements
    want = torch_worlds[1][0]
    for world in WORLDS[1:]:
        for rank, res in enumerate(torch_worlds[world]):
            for leaf in LEAVES:
                key = f"{tag}{name}/{leaf}"
                np.testing.assert_array_equal(_bits(res[key]), _bits(want[key]),
                                              err_msg=f"{world} ranks, rank {rank}")


def test_loss_fold_and_training_identical_across_placements(placements):
    """3 logical-worker steps (W = 4, bucketed fpisa): the losses, folded
    left to right over the gathered (W,) vector, and the weights are the
    same bits on 1, 2 and 4 ranks."""
    _, torch_worlds, _ = placements
    want = torch_worlds[1][0]
    assert want["train/losses"].dtype == np.float32 and np.all(np.isfinite(want["train/losses"]))
    for world in WORLDS:
        for res in torch_worlds[world]:
            np.testing.assert_array_equal(_bits(res["train/losses"]), _bits(want["train/losses"]))
            np.testing.assert_array_equal(_bits(res["train/params"]), _bits(want["train/params"]))


# ---------------------------------------------------------------------------
# in process: bucketed stacked == per-leaf stacked
# ---------------------------------------------------------------------------

IN_PROCESS = ([("native", 32, "fp32"), ("switch_emu", 32, "fp32")]
              + [("switchml", 32, f) for f in FMTS] + [("fpisa_seq", 32, f) for f in FMTS]
              + [("fpisa", w, f) for w in WIRES for f in FMTS])


@pytest.fixture(params=["torch", "cuda-composition"])
def backend_path(request, monkeypatch):
    if request.param != "torch":
        def as_cuda(backend, device=None):
            return backend if device is None else "cuda"

        monkeypatch.setattr(tagg, "resolve_backend", as_cuda)
        monkeypatch.setattr(tar, "resolve_backend", as_cuda)
    return request.param


@pytest.mark.parametrize("strategy,wire,fmt", IN_PROCESS,
                         ids=[f"{s}-w{w}-{f}" for s, w, f in IN_PROCESS])
def test_bucketed_stacked_equals_per_leaf_in_process(backend_path, strategy, wire, fmt):
    trees = RAGGED[1:2] if strategy == "switch_emu" else RAGGED
    for i, shapes in enumerate(trees):
        workers = [_tree(shapes, seed=100 * i + j) for j in range(3)]
        tree = {k: torch.stack([t[k] for t in workers]) for k in workers[0]}
        base = dict(strategy=strategy, wire_bits=wire, fmt_name=fmt)
        want = Aggregator(AggConfig(**base), stacked=True).allreduce_tree(tree)
        for bucket_bytes in (2048, 8192, 1 << 20):
            got = Aggregator(AggConfig(bucket_bytes=bucket_bytes, **base),
                             stacked=True).allreduce_tree(tree)
            _equal_trees(got, want, (i, bucket_bytes))


def test_stacked_plan_is_the_unstacked_plan():
    """The wire layout does not depend on k: bucket cuts and block
    boundaries of a stacked tree are those of its per-worker tree."""
    from repro_torch.core import bucketer

    seen = []
    real = bucketer._stream_buckets

    def spy(plan, *a, **kw):
        seen.append(plan)
        return real(plan, *a, **kw)

    tree = _tree(RAGGED[0], seed=4)
    try:
        bucketer._stream_buckets = spy
        for k in (1, 2, 4):
            Aggregator(AggConfig(bucket_bytes=4096), stacked=True).allreduce_tree(
                {n: torch.stack([v] * k) for n, v in tree.items()})
    finally:
        bucketer._stream_buckets = real
    want = bucketer.make_plan(list(tree.values()), block=256, bucket_bytes=4096)
    assert seen == [want] * 3


# ---------------------------------------------------------------------------
# the logical-worker train step against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """The JAX side: initial weights, 3 logical-worker steps (W = 4, one
    device), and the per-worker step-0 gradients with their stacked fpisa
    aggregation (per leaf and bucketed)."""
    cfg = jax_smoke(ARCH)
    model = jax_build(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    mesh = make_mesh_for(jax.devices()[:1])
    agg = JaxAggConfig(strategy="fpisa", backend="jnp")
    opt_cfg = jax_opt.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
    loader = JaxLoader(JaxCorpus(cfg.vocab_size, 0), BATCH, SEQ)
    step = jax.jit(jax_make_train_step(model, mesh, agg, opt_cfg, BATCH, logical_workers=W))
    p, opt_state = params, jax_opt.init(params, opt_cfg)
    losses, gnorms = [], []
    for i in range(STEPS):
        p, opt_state, metrics = step(p, opt_state,
                                     {"tokens": jnp.asarray(loader.batch_at(i)["tokens"])})
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    tokens = jnp.asarray(loader.batch_at(0)["tokens"])
    grad = jax.jit(jax.grad(model.loss))
    per_worker = [grad(params, {"tokens": tokens[j:j + 1]}) for j in range(W)]
    stacked = jax.tree.map(lambda *g: jnp.stack(g), *per_worker)
    aggregated = {}
    for bucket_bytes in (0, 4096):
        aggregator = JaxAggregator(JaxAggConfig(strategy="fpisa", backend="jnp",
                                                bucket_bytes=bucket_bytes), ("data",),
                                   stacked=True)
        fn = jax.jit(compat.shard_map(aggregator.allreduce_tree, mesh=mesh, in_specs=(P(),),
                                      out_specs=P(), axis_names={"data"}))
        aggregated[bucket_bytes] = jax.tree.map(np.asarray, fn(stacked))
    return {"init": jax.tree.map(np.asarray, params), "losses": losses, "gnorms": gnorms,
            "stacked": jax.tree.map(np.asarray, stacked), "aggregated": aggregated}


def test_logical_worker_step_tracks_the_reference(reference):
    cfg = get_smoke_config(ARCH)
    model = build(cfg, device=torch.device("cpu"), params=params_from_jax(reference["init"]))
    opt_cfg = optimizers.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
    step = make_train_step(model, AggConfig(strategy="fpisa"), opt_cfg, BATCH,
                           logical_workers=W)
    opt_state = optimizers.init(list(model.parameters()), opt_cfg)
    loader = ShardedLoader(SyntheticCorpus(cfg.vocab_size, 0), BATCH, SEQ)
    losses, gnorms = [], []
    for i in range(STEPS):
        opt_state, metrics = step(opt_state,
                                  {"tokens": torch.from_numpy(loader.batch_at(i)["tokens"])})
        assert metrics["loss"].dtype == torch.float32
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    np.testing.assert_allclose(losses[0], reference["losses"][0], rtol=2e-6)
    np.testing.assert_allclose(losses, reference["losses"], rtol=2e-5)
    np.testing.assert_allclose(gnorms, reference["gnorms"], rtol=2e-5)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("bucket_bytes", [0, 4096])
def test_aggregated_per_worker_gradients_bit_exact(reference, bucket_bytes):
    """The reference's 4 per-worker step-0 gradients through both stacked
    aggregators: bit-exact, per leaf and bucketed."""
    tree = params_from_jax(reference["stacked"])
    out = Aggregator(AggConfig(strategy="fpisa", bucket_bytes=bucket_bytes),
                     stacked=True).allreduce_tree(tree)
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), out))
    want = jax.tree.leaves(reference["aggregated"][bucket_bytes])
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_stacked_refusals_keep_the_reference_messages(monkeypatch):
    with pytest.raises(ValueError, match="chunk_elems is not supported with stacked"):
        Aggregator(AggConfig(chunk_elems=256), stacked=True)
    with pytest.raises(ValueError, match="fp32-only"):
        Aggregator(AggConfig(strategy="switch_emu", fmt_name="bf16"), stacked=True)
    with pytest.raises(ValueError, match="does not support a shared dataplane"):
        tar.stacked_switch_emu_allreduce(torch.ones(2, 8), None,
                                         AggConfig(strategy="switch_emu", switch_shared="pool",
                                                   switch_jobs=2))
    with pytest.raises(ValueError, match="leading worker axis"):
        Aggregator(AggConfig(), stacked=True).allreduce(torch.tensor(1.0))
    monkeypatch.setitem(tagg._REGISTRY, "flat_only",
                        tagg.StrategySpec(name="flat_only", fn=tar.native_allreduce))
    with pytest.raises(ValueError, match="stacked-capable strategies: fpisa, fpisa_seq"):
        Aggregator(AggConfig(strategy="flat_only"), stacked=True)
    Aggregator(AggConfig(strategy="flat_only"))  # the flat path is unaffected


@pytest.mark.parametrize("kwargs,match", [
    (dict(agg=AggConfig(strategy="native")), "non-native strategy"),
    (dict(accum_steps=2), "incompatible with accum_steps"),
    (dict(global_batch=6), "divide global_batch=6"),
])
def test_logical_worker_step_refusals(kwargs, match):
    model = build(get_smoke_config(ARCH), device=torch.device("cpu"))
    args = dict(agg=AggConfig(), opt_cfg=optimizers.OptConfig(), global_batch=BATCH,
                logical_workers=W)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        make_train_step(model, **args)
