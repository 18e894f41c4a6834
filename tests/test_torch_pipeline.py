"""The port's pipeline stages (repro_torch.train.pipeline) against the JAX
reference's (repro.train.pipeline).

One JAX run on 4 host devices computes the reference's ``make_pp_loss`` and
``jax.grad`` of it at 2 and 4 stages (a ``("pod",)`` stage mesh), beside
the plain model's loss and gradients, for stablelm-3b's smoke config at 4
layers (untied head) and qwen1.5-0.5b's at 4 layers (tied embeddings, QKV
bias). The port runs ``make_pp_loss`` on 2 and 4 gloo ranks (file://
rendezvous) from the same weights (the port's seeded init, through
``interop.params_to_jax`` / ``params_from_jax``) and batch,
4 microbatches, and every rank reports its loss and the gradient of every
leaf: its layer chunk, and the embedding, final norm and head whole.

Held: on every rank, the loss within 2e-5 of the reference pipeline's, and
every leaf's gradient (the chunks gathered in stage order) within rtol
1e-3, atol 1e-6 of the reference's ``jax.grad(pp_loss)`` (float32 weights;
the frameworks' float32 products and reductions round differently). The
reference's own pipeline gradients are the plain model's (its
``jax.grad(model.loss)``), leaf for leaf, and so are the port's: no leaf is
summed over the stage axis. One stage on one process equals ``model.loss``
and its gradients within the reference test's tolerances (2e-3 on the loss;
rtol 2e-2, atol 2e-4), the check the card repeats at full width.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = (2, 4)
ARCHS = ("stablelm-3b", "qwen1.5-0.5b")

JAX_CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from repro import compat
from repro.configs import get_smoke_config
from repro.models.registry import build
from repro.train.pipeline import make_pp_loss, split_stages
inp = np.load(%(inp)r)
key = lambda kp: "/".join(str(k.key) for k in kp)
out = {}
for arch in %(archs)r:
    cfg = get_smoke_config(arch).with_(num_layers=4, d_model=64)
    model = build(cfg)
    like = jax.eval_shape(model.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    params = jax.tree_util.tree_map_with_path(
        lambda kp, _: jnp.asarray(inp[f"{arch}/param/{key(kp)}"]), like)
    batch = {"tokens": jnp.asarray(inp[f"{arch}/tokens"])}
    loss, grads = jax.value_and_grad(model.loss)(params, batch)
    out[f"{arch}/plain/loss"] = np.asarray(loss)
    for kp, v in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"{arch}/plain/{key(kp)}"] = np.asarray(v)
    for n in %(stages)r:
        mesh = compat.make_mesh((n,), ("pod",), devices=jax.devices()[:n])
        pp = make_pp_loss(cfg, mesh, stage_axis="pod", n_micro=4)
        loss, g = jax.jit(jax.value_and_grad(pp))(split_stages(params, n), batch)
        out[f"{arch}/pp{n}/loss"] = np.asarray(loss)
        for kp, v in jax.tree_util.tree_flatten_with_path(g)[0]:
            a = np.asarray(v)
            if key(kp).startswith("layers/"):
                a = a.reshape(-1, *a.shape[2:])
            out[f"{arch}/pp{n}/{key(kp)}"] = a
np.savez(%(out)r, **out)
"""

TORCH_CODE = r"""
import os, numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.models.transformer import _tree_map
from repro_torch.train.pipeline import make_pp_loss, split_stages
rank, W = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=%(init)r, rank=rank, world_size=W)
ref = np.load(%(inp)r)
res = {}
for arch in %(archs)r:
    cfg = get_smoke_config(arch).with_(num_layers=4, d_model=64)
    tree = {}
    for k in ref.files:
        if k.startswith(arch + "/param/"):
            node = tree
            *path, leaf = k[len(arch) + 7:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = ref[k]
    tree = _tree_map(lambda t: t.requires_grad_(True), params_from_jax(tree))
    leaves = {}
    def walk(t, pre=""):
        for k, v in t.items():
            walk(v, pre + k + "/") if isinstance(v, dict) else leaves.setdefault(pre + k, v)
    walk(tree)
    batch = {"tokens": torch.from_numpy(ref[arch + "/tokens"]).long()}
    loss = make_pp_loss(cfg, None, n_micro=4)(split_stages(tree, W), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    res[arch + "/loss"] = loss.detach().numpy()
    for k, g in zip(leaves, grads):
        if k.startswith("layers/"):  # this stage's chunk
            g = g.reshape(W, -1, *g.shape[1:])[rank]
        res[arch + "/" + k] = g.numpy()
np.savez(os.environ["OUT"], **res)
dist.destroy_process_group()
"""


def _inputs(path: str) -> None:
    """Seeded float32 weights (the port's init, seed 0) and tokens of each
    arch, for both frameworks."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import params_to_jax
    from repro_torch.models.registry import build

    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch).with_(num_layers=4, d_model=64)

        def walk(t, pre):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, f"{pre}{k}/")
                else:
                    out[f"{arch}/param/{pre}{k}"] = v
        walk(params_to_jax(build(cfg, device=torch.device("cpu"), seed=0)), "")
        out[f"{arch}/tokens"] = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (8, 32)).astype(np.int32)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, multi_device_runner):
    tmp = tmp_path_factory.mktemp("pipeline")
    inp, ref = str(tmp / "inputs.npz"), str(tmp / "jax.npz")
    _inputs(inp)
    # the JAX run and the gloo ranks at once, one thread per rank
    pool = ThreadPoolExecutor(1)
    jax_run = pool.submit(multi_device_runner, JAX_CODE % dict(
        archs=ARCHS, stages=STAGES, inp=inp, out=ref), n_devices=4, timeout=600)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs, outs = [], {}
    for w in STAGES:
        code = TORCH_CODE % dict(init=f"file://{tmp}/pg{w}", inp=inp, archs=ARCHS)
        outs[w] = [str(tmp / f"torch{w}_{r}.npz") for r in range(w)]
        for r in range(w):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=dict(env, RANK=str(r), WORLD_SIZE=str(w), OUT=outs[w][r])))
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-4000:]
        jax_run.result()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        pool.shutdown()
    return dict(np.load(ref)), {w: [dict(np.load(o)) for o in outs[w]] for w in STAGES}


def _leaves(ref, arch, tag):
    pre = f"{arch}/{tag}/"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre) and k != pre + "loss"}


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_pipeline_gradients_are_the_plain_models(runs, arch):
    ref, _ = runs
    plain = _leaves(ref, arch, "plain")
    for n in STAGES:
        assert abs(float(ref[f"{arch}/pp{n}/loss"]) - float(ref[f"{arch}/plain/loss"])) < 2e-5
        for k, g in _leaves(ref, arch, f"pp{n}").items():
            np.testing.assert_allclose(g.reshape(plain[k].shape), plain[k], rtol=1e-3,
                                       atol=1e-6, err_msg=f"{arch} pp{n} {k}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("stages", STAGES)
def test_pipeline_loss_and_every_gradient_match_reference(runs, arch, stages):
    ref, ranks = runs
    want = _leaves(ref, arch, f"pp{stages}")
    for res in ranks[stages]:
        assert abs(float(res[arch + "/loss"]) - float(ref[f"{arch}/pp{stages}/loss"])) < 2e-5
    for k, w in want.items():
        if k.startswith("layers/"):
            got = np.concatenate([res[f"{arch}/{k}"] for res in ranks[stages]])
            np.testing.assert_allclose(got, w, rtol=1e-3, atol=1e-6, err_msg=f"{arch} {k}")
        else:
            for r, res in enumerate(ranks[stages]):
                np.testing.assert_allclose(res[f"{arch}/{k}"], w, rtol=1e-3, atol=1e-6,
                                           err_msg=f"{arch} {k} on stage {r}")


def test_one_stage_equals_model_loss():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build
    from repro_torch.train.pipeline import make_pp_loss, param_tree, split_stages

    cfg = get_smoke_config("qwen1.5-0.5b")
    model = build(cfg, device=torch.device("cpu"), seed=0)
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 32), generator=gen)}
    params = list(model.parameters())
    want = model.loss(batch)
    gw = torch.autograd.grad(want, params)
    got = make_pp_loss(cfg, None, n_micro=4)(split_stages(param_tree(model), 1), batch)
    gg = torch.autograd.grad(got, params)
    assert abs(float(got.detach()) - float(want.detach())) < 2e-3
    for a, b in zip(gg, gw):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-4)


def test_pipeline_refuses_other_families_and_uneven_stages():
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.pipeline import make_pp_loss, split_stages

    with pytest.raises(ValueError, match="dense blocks"):
        make_pp_loss(get_smoke_config("mamba2-780m"))
    with pytest.raises(ValueError, match="do not split"):
        split_stages({"layers": {"w": torch.zeros(3, 2)}}, 2)
