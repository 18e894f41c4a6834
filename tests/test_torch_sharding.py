"""The port's sharding rules, DTensor placements and mesh step
(repro_torch.sharding, launch/mesh.py, launch/specs.py, train/step.py on a
DeviceMesh) against the JAX reference (repro.sharding.rules).

* Rules, exact: for all 10 architectures on both production meshes
  (``compat.abstract_mesh``, as tests/test_sharding.py builds them), the
  port's parameter, optimizer (ZeRO-1), cache (decode_32k, prefill_32k,
  long_500k) and input specs equal the reference's leaf for leaf, and
  ``attn_mode`` equals it at every model-axis size 1-16. The port's own
  versions of test_sharding.py's checks follow as parametrised cases:
  every spec valid (sharded dims divisible), the expected TP modes, big
  leaves sharded, cache specs divisible. The meta build of kimi-k2 (1.04 T
  parameters) allocates nothing.
* Gloo, 4 ranks (file:// rendezvous), one spawn for all of:
  - fixed per-rank gradients (DTensors on the 'model' sub-mesh, some
    ``Partial``, some sharded as their parameters) aggregated by the mesh
    step's ``MeshGrads`` on (data 2, model 2) give the bits of the (data 2)
    group's plain aggregation of the whole leaves, for fpisa at wire 32,
    fpisa at wire 16 bucketed, and fpisa_seq;
  - a smoke-size TP train step (qwen1.5-0.5b on (data 2, model 2), in
    the 'head', 'hdim' and 'qhead' attention modes, and in 'head' mode
    under ``remat="dots"``) keeps the replica step's losses within rtol
    1e-5 (float32; TP sums partial products in another order);
  - arctic-480b's smoke config on (pod 2, data 1, model 2) takes the pod
    boundary (FPISA over ``mesh["pod"]`` alone) and keeps the 2-rank
    replica run's losses within rtol 1e-5; on (data 2, model 2), with no
    pod axis, its step is the plain native step and keeps a single
    process's losses on the global batch within rtol 1e-5;
  - on (data 4, model 1), a step with W = 4 logical workers, one with
    chunked and one with bucketed aggregation give the plain group step's
    loss and parameter bits;
  - a checkpointed mesh run resumed after step 1 repeats the
    uninterrupted mesh run's losses exactly (checkpoints hold whole
    tensors; the launcher places them again).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import MeshShape, production_shape  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single": (compat.abstract_mesh((16, 16), ("data", "model")), production_shape(False)),
          "multipod": (compat.abstract_mesh((2, 16, 16), ("pod", "data", "model")),
                       production_shape(True))}
_JAX_MODELS: dict = {}


def _jmodel(arch):
    if arch not in _JAX_MODELS:
        _JAX_MODELS[arch] = jbuild(jget_config(arch))
    return _JAX_MODELS[arch]


def _jspecs(tree, specs):
    flat, _ = jrules._tree_paths(tree)
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    return {path: tuple(s) for (path, _), s in zip(flat, leaves)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_equal_reference(arch, mesh):
    jmesh, tmesh = MESHES[mesh]
    cfg, jcfg = get_config(arch), jget_config(arch)
    jmodel = _jmodel(arch)
    p_sds = JS.param_specs(jmodel)
    jp = jrules.param_pspecs(p_sds, jcfg, jmesh)
    model = S.meta_model(cfg)
    tp = rules.param_pspecs(model, cfg, tmesh)
    assert tp == _jspecs(p_sds, jp)
    assert rules.opt_pspecs(tp, model, tmesh) == _jspecs(p_sds, jrules.opt_pspecs(jp, p_sds, jmesh))
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        want = jrules.input_pspecs(JS.input_specs(jcfg, jshape), jmesh, jshape.global_batch)
        got = rules.input_pspecs(S.input_specs(cfg, shape), tmesh, shape.global_batch)
        assert got == {k: tuple(v) for k, v in want.items()}, name
        if shape.kind == "train":
            continue
        jc = JS.cache_specs(jmodel, jshape.global_batch, jshape.seq_len)
        want = _jspecs(jc, jrules.cache_pspecs(jc, jmesh, jshape.global_batch, jcfg))
        cache = S.cache_specs(model, shape.global_batch, shape.seq_len)
        assert rules.cache_pspecs(cache, tmesh, shape.global_batch, cfg) == want, name


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_attn_mode_equals_reference(arch):
    for m in range(1, 17):
        assert rules.attn_mode(get_config(arch), m) == jrules.attn_mode(jget_config(arch), m)


def _axis_size(mesh: MeshShape, part):
    if part is None:
        return 1
    parts = part if isinstance(part, tuple) else (part,)
    return int(np.prod([mesh.shape[p] for p in parts]))


def _check_valid(leaves: dict, specs: dict, mesh: MeshShape, where):
    assert set(leaves) == set(specs), where
    for path, leaf in leaves.items():
        spec = specs[path]
        assert len(spec) <= len(leaf.shape), (where, path, leaf.shape, spec)
        for dim, part in zip(leaf.shape, spec):
            assert dim % _axis_size(mesh, part) == 0, (where, path, leaf.shape, spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_opt_specs_valid(arch, mesh):
    tmesh = MESHES[mesh][1]
    cfg = get_config(arch)
    model = S.meta_model(cfg)
    leaves = dict(rules.tree_paths(model))
    pspecs = rules.param_pspecs(model, cfg, tmesh)
    _check_valid(leaves, pspecs, tmesh, arch)
    opt = S.opt_specs(S.param_specs(model), optimizers.OptConfig())
    assert all(t.device.type == "meta" for t in opt.m + opt.v)
    _check_valid(leaves, rules.opt_pspecs(pspecs, model, tmesh), tmesh, arch + "/opt")


@pytest.mark.parametrize("arch,expected", [
    ("qwen1.5-0.5b", "head"), ("internlm2-20b", "qhead"), ("deepseek-67b", "qhead"),
    ("stablelm-3b", "head"), ("arctic-480b", "hdim"), ("kimi-k2-1t-a32b", "qhead"),
    ("zamba2-7b", "head"), ("llava-next-34b", "hdim"), ("whisper-medium", "head"),
    ("mamba2-780m", "none")])
def test_attention_tp_modes(arch, expected):
    assert rules.attn_mode(get_config(arch), 16) == expected


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_big_params_are_sharded(arch):
    """Every leaf of 64 MiB or more is sharded on some axis, except the
    reference's by-design exceptions (KV weights under qhead duplication,
    vocab tensors whose size does not divide the model axis)."""
    cfg = get_config(arch)
    model = S.meta_model(cfg)
    pspecs = rules.param_pspecs(model, cfg, MESHES["single"][1])
    mode = rules.attn_mode(cfg, 16)
    for path, leaf in rules.tree_paths(model):
        if leaf.numel() * leaf.element_size() < 64 << 20:
            continue
        if mode == "qhead" and any(f"/{w}" in path for w in ("wk", "wv", "bk", "bv")):
            continue
        if cfg.vocab_size % 16 and ("embed/tok" in path or "head/w" in path):
            continue
        assert any(p is not None for p in pspecs[path]), (arch, path, leaf.shape)


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ARCH_NAMES for s in ("decode_32k", "prefill_32k", "long_500k")
    if shape_applicable(get_config(a), SHAPES[s])])
def test_cache_specs_valid(arch, shape):
    cfg = get_config(arch)
    sh = SHAPES[shape]
    cache = S.cache_specs(S.meta_model(cfg), sh.global_batch, sh.seq_len)
    tmesh = MESHES["single"][1]
    specs = rules.cache_pspecs(cache, tmesh, sh.global_batch, cfg)
    for path, leaf in rules.tree_paths(cache):
        if not isinstance(leaf, torch.Tensor):
            continue
        for dim, part in zip(leaf.shape, specs[path]):
            assert dim % _axis_size(tmesh, part) == 0, (arch, path, leaf.shape, specs[path])


def test_meta_build_allocates_nothing():
    model = S.meta_model(get_config("kimi-k2-1t-a32b"))
    assert sum(p.numel() for p in model.parameters()) == 1_041_166_988_288
    assert all(p.device.type == "meta" for p in model.parameters())


@pytest.mark.parametrize("spec,want", [
    ((None, "model"), ("R", "S1")), (("data", None), ("S0", "R")),
    ((("pod", "data"), None, "model"), ("S0", "S0", "S2")), ((None, None), ("R", "R"))])
def test_placements_follow_the_mesh_order(spec, want):
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    names = [f"S{p.dim}" if hasattr(p, "dim") else "R" for p in rules.placements(spec, mesh)]
    full = {"pod": names[0], "data": names[1], "model": names[2]}
    got = tuple(full[a] for a in ("data", "model")) if len(want) == 2 else tuple(names)
    assert got == want


def test_placements_refuse_axes_out_of_mesh_order():
    with pytest.raises(ValueError, match="axis order"):
        rules.placements((("data", "pod"),), MeshShape(("pod", "data"), (2, 2)))


def test_mesh_shapes_match_the_reference_layouts():
    from repro_torch.launch.mesh import mesh_shape_for

    assert mesh_shape_for(8, 2).shape == {"data": 4, "model": 2}
    assert mesh_shape_for(8, 2, 2).shape == {"pod": 2, "data": 2, "model": 2}
    assert mesh_shape_for(4, data_only=True).shape == {"data": 4}
    with pytest.raises(ValueError, match="cannot lay 6 devices"):
        mesh_shape_for(6, 4)
    with pytest.raises(ValueError, match="data_only"):
        mesh_shape_for(4, 2, data_only=True)


GLOO_CODE = r"""
import os, numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, distribute_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.core.agg import AggConfig, Aggregator
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.train import train_loop
from repro_torch.models.registry import build
from repro_torch.sharding import rules
from repro_torch.train.step import MeshGrads, replica_axes
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method=%(init)r, rank=rank, world_size=4)
cpu = torch.device("cpu")
res = {}
# (1) fixed per-rank gradients through MeshGrads on (data 2, model 2)
mesh = make_mesh_for(4, model_parallel=2)
cfg = get_smoke_config("qwen1.5-0.5b")
model = build(cfg, device=cpu, seed=0)
rules.distribute(model, cfg, mesh)
d = mesh.get_local_rank("data")
rng = np.random.default_rng(100 + d)
names = [n for n, _ in model.named_parameters()]
whole = {n: torch.from_numpy((rng.standard_normal(p.shape) * np.exp2(rng.integers(-8, 8, p.shape)))
                             .astype(np.float32)) for n, p in model.named_parameters()}
for tag, kw in (("w32", {}), ("w16b", dict(wire_bits=16, bucket_bytes=4096)),
                ("seq", dict(strategy="fpisa_seq"))):
    agg = AggConfig(**kw)
    plan = MeshGrads(model, mesh, agg)
    views = plan.views()
    grads = []
    for i, (n, v) in enumerate(views.items()):
        if i %% 2:  # a partial sum over 'model': two exact halves
            grads.append(DTensor.from_local(whole[n] / 2, plan.cmesh, [Partial()]))
        else:
            grads.append(distribute_tensor(whole[n], plan.cmesh, v.placements, src_data_rank=None))
    pairs = [plan.local(g, v) for g, v in zip(grads, views.values())]
    got = plan.aggregate([g for g, _ in pairs], [t for _, t in pairs], views)
    want = Aggregator(agg, mesh["data"].get_group()).allreduce_tree(dict(whole))
    for n, g in zip(names, got):
        res[f"agg/{tag}/{n}/got"] = g.full_tensor().numpy()
        res[f"agg/{tag}/{n}/want"] = want[n].numpy()
        res[f"agg/{tag}/{n}/placed"] = np.array(str(g.placements))
kw = dict(steps=3, global_batch=8, seq_len=32, device=cpu, log_every=99)
# (2) a TP train step against the replica step
_, _, res["tp/mesh"] = train_loop(cfg, mesh=mesh, **kw)
_, _, res["tp/replica"] = train_loop(cfg, group=mesh["data"].get_group(), **kw)
# the other attention TP modes at model = 2: 'hdim' (3 heads of 16) and
# 'qhead' (4 query heads, 1 K/V head, replicated)
for mode, over in (("hdim", dict(num_heads=3, num_kv_heads=3, head_dim=16)),
                   ("qhead", dict(num_heads=4, num_kv_heads=1))):
    mcfg = cfg.with_(**over)
    assert rules.attn_mode(mcfg, 2) == mode
    _, _, res[f"tp/{mode}/mesh"] = train_loop(mcfg, mesh=mesh, **dict(kw, steps=2))
    _, _, res[f"tp/{mode}/replica"] = train_loop(mcfg, group=mesh["data"].get_group(),
                                                 **dict(kw, steps=2))
# remat="dots" (selective checkpointing) on the head-mode TP step
dcfg = cfg.with_(remat="dots")
_, _, res["tp/dots/mesh"] = train_loop(dcfg, mesh=mesh, **dict(kw, steps=2))
_, _, res["tp/dots/replica"] = train_loop(dcfg, group=mesh["data"].get_group(),
                                          **dict(kw, steps=2))
# (3) arctic: the pod boundary, and no boundary without a pod axis
acfg = get_smoke_config("arctic-480b")
pmesh = make_mesh_for(4, model_parallel=2, pods=2)
res["arctic/boundary"] = np.array(replica_axes(pmesh, acfg))
akw = dict(kw, steps=2)
_, _, res["arctic/pod"] = train_loop(acfg, mesh=pmesh, **akw)
_, _, res["arctic/replica"] = train_loop(acfg, group=pmesh["pod"].get_group(), **akw)
_, _, res["arctic/nopod"] = train_loop(acfg, mesh=mesh, **akw)
# (4) on (data 4, model 1): logical workers, chunks and buckets keep the
# group step's bits
from repro_torch.optim import optimizers
from repro_torch.train.step import make_train_step
mesh4 = make_mesh_for(4)
opt_cfg = optimizers.OptConfig()
tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (8, 32)))
local = {"tokens": tokens[rules.batch_slice(mesh4, 8)]}
for tag, akw, lw in (("workers", {}, 4), ("chunk", dict(chunk_elems=512), 0),
                     ("bucket", dict(bucket_bytes=4096), 0)):
    a, b = build(cfg, device=cpu, seed=0), build(cfg, device=cpu, seed=0)
    oa = rules.distribute(a, cfg, mesh4, optimizers.init(list(a.parameters()), opt_cfg))
    ob = optimizers.init(list(b.parameters()), opt_cfg)
    oa, ma = make_train_step(a, AggConfig(**akw), opt_cfg, 8, mesh=mesh4, logical_workers=lw)(oa, local)
    ob, mb = make_train_step(b, AggConfig(**akw), opt_cfg, 8, logical_workers=lw)(ob, local)
    res[f"m1/{tag}/loss"] = np.array([float(ma["loss"]), float(mb["loss"])])
    res[f"m1/{tag}/same"] = np.array([torch.equal(p.full_tensor().view(torch.int32),
                                                  q.detach().view(torch.int32))
                                      for p, q in zip(a.parameters(), b.parameters())])
# (5) checkpointed resume on the mesh
ck = %(ck)r
dist.barrier()
_, _, first = train_loop(cfg, mesh=mesh, ckpt_dir=ck, ckpt_every=1, **dict(kw, steps=2))
dist.barrier()  # rank 0 has written the bundle
_, _, rest = train_loop(cfg, mesh=mesh, ckpt_dir=ck, ckpt_every=1, **kw)
res["ckpt/resumed"] = np.array(first + rest)
np.savez(os.environ["OUT"], **{k: np.asarray(v) for k, v in res.items()})
dist.destroy_process_group()
"""

SINGLE_CODE = r"""
import os, numpy as np, torch
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import train_loop
_, _, losses = train_loop(get_smoke_config("arctic-480b"), steps=2, global_batch=8, seq_len=32,
                          device=torch.device("cpu"), log_every=99)
np.save(os.environ["OUT"], np.array(losses))
"""


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    # one thread per rank: five processes share the host's cores
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    code = GLOO_CODE % dict(init=f"file://{tmp}/pg", ck=str(tmp / "ck"))
    outs = [str(tmp / f"rank{r}.npz") for r in range(4)]
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=dict(env, RANK=str(r), OUT=outs[r])) for r in range(4)]
    single = str(tmp / "single.npy")
    procs.append(subprocess.Popen([sys.executable, "-c", SINGLE_CODE], cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env=dict(env, OUT=single)))
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [dict(np.load(o)) for o in outs], np.load(single)


@pytest.mark.parametrize("tag", ["w32", "w16b", "seq"])
def test_mesh_aggregation_equals_unsharded_bits(gloo, tag):
    ranks, _ = gloo
    for r, res in enumerate(ranks):
        keys = [k[:-4] for k in res if k.startswith(f"agg/{tag}/") and k.endswith("/got")]
        assert len(keys) == 14
        for k in keys:
            got, want = res[k + "/got"], res[k + "/want"]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), (r, k)


@pytest.mark.parametrize("mode", ["head", "hdim", "qhead", "dots"])
def test_tp_step_keeps_the_replica_losses(gloo, mode):
    ranks, _ = gloo
    tag = "tp" if mode == "head" else f"tp/{mode}"
    for res in ranks:
        np.testing.assert_allclose(res[f"{tag}/mesh"], res[f"{tag}/replica"], rtol=1e-5)


def test_arctic_takes_the_pod_boundary(gloo):
    ranks, single = gloo
    for res in ranks:
        assert tuple(res["arctic/boundary"]) == ("pod",)
        np.testing.assert_allclose(res["arctic/pod"], res["arctic/replica"], rtol=1e-5)
        np.testing.assert_allclose(res["arctic/nopod"], single, rtol=1e-5)


@pytest.mark.parametrize("tag", ["workers", "chunk", "bucket"])
def test_model_axis_of_one_keeps_the_group_bits(gloo, tag):
    """Logical workers (W = 4), chunked and bucketed aggregation on a
    (data 4, model 1) mesh: the same loss and parameter bits as the plain
    group step after one step."""
    ranks, _ = gloo
    for res in ranks:
        loss = res[f"m1/{tag}/loss"]
        assert loss[0] == loss[1]
        assert res[f"m1/{tag}/same"].all()


def test_mesh_checkpoint_resume_repeats_the_run(gloo):
    ranks, _ = gloo
    for res in ranks:
        assert res["ckpt/resumed"].tolist() == res["tp/mesh"].tolist()
