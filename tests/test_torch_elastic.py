"""Restore onto meshes of other sizes: the port's counterpart of the
reference's tests/test_integration.py::test_elastic_restore_across_mesh_sizes.

The smoke internlm2-20b's parameters are saved once with
``runtime/checkpoint.save``. Two gloo runs (file:// rendezvous under the
test's tmp directory) restore them with ``checkpoint.restore`` into a model
built from another seed, build their mesh with
``launch/mesh.py::make_mesh_for(world, model_parallel=2)`` and place the
parameters with ``sharding/rules.distribute``: 4 ranks as a (data 2, model
2) mesh and 2 ranks as a (data 1, model 2) mesh. ``make_mesh_for`` builds
over the whole default group, so each mesh size is a spawn of its own; the
reference's (4, 2) and (2, 2) meshes over 8 devices become (2, 2) and
(1, 2) here, so that the model axis the restore shards over stays 2 while
the file keeps to 6 processes. On every rank the loss of a seeded (4, 32)
batch (a DTensor split over the batch axes) must be within 1e-4 of the
unsharded model's, the reference's bound.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim.optimizers import OptState  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "internlm2-20b"
MESHES = {4: (2, 2), 2: (1, 2)}  # world -> (data, model)
NO_OPT = OptState(step=0, m=None, v=None)

RANK_CODE = r"""
import os, numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models.registry import build
from repro_torch.optim.optimizers import OptState
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.sharding import hints, rules

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank, world_size=world)
cfg = get_smoke_config(%(arch)r)
model = build(cfg, device=torch.device("cpu"), seed=1)  # restore must overwrite these
none = OptState(step=0, m=None, v=None)
tree, _ = ckpt.restore(os.environ["CK"], 0, ckpt.state_trees(model, none)["params"])
ckpt.load_state(model, none, {"params": tree})
mesh = make_mesh_for(world, model_parallel=2)
rules.distribute(model, cfg, mesh)
tokens = torch.from_numpy(np.load(os.environ["TOK"]))
batch = [Shard(0) if a in rules.batch_axes(mesh, 4) else Replicate()
         for a in mesh.mesh_dim_names]
tokens = DTensor.from_local(tokens[rules.batch_slice(mesh, 4)], mesh, batch, run_check=False)
with torch.no_grad(), hints.use_mesh(mesh), implicit_replication():
    loss = model.loss({"tokens": tokens}).full_tensor()
np.savez(os.environ["OUT"], loss=float(loss), mesh=np.array(mesh.mesh.shape),
         tok_rows=model.embed.tok.to_local().shape[0])
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    cfg = get_smoke_config(ARCH)
    model = build(cfg, device=torch.device("cpu"), seed=0)
    ckpt.save(str(tmp / "ck"), 0, ckpt.state_trees(model, NO_OPT)["params"])
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32))
    np.save(tmp / "tok.npy", tokens)
    with torch.no_grad():
        unsharded = float(model.loss({"tokens": torch.from_numpy(tokens)}))
        other = float(build(cfg, device=torch.device("cpu"), seed=1)
                      .loss({"tokens": torch.from_numpy(tokens)}))
    # one thread per rank: six processes share the host's cores
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               CK=str(tmp / "ck"), TOK=str(tmp / "tok.npy"))
    code = RANK_CODE % dict(arch=ARCH)
    outs = {(w, r): str(tmp / f"w{w}_r{r}.npz") for w in MESHES for r in range(w)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=dict(env, RANK=str(r), WORLD=str(w), OUT=out,
                                       INIT=f"file://{tmp}/pg{w}"))
             for (w, r), out in outs.items()]
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return unsharded, other, {k: dict(np.load(v)) for k, v in outs.items()}


@pytest.mark.parametrize("world", list(MESHES))
def test_restore_across_mesh_sizes_keeps_the_loss(restored, world):
    unsharded, other, runs = restored
    assert abs(other - unsharded) > 1e-3  # the restore is what sets the loss
    vocab = get_smoke_config(ARCH).vocab_size
    for r in range(world):
        res = runs[(world, r)]
        assert tuple(res["mesh"]) == MESHES[world]
        assert int(res["tok_rows"]) == vocab // 2  # the embedding is sharded over 'model'
        assert abs(float(res["loss"]) - unsharded) < 1e-4, (world, r, float(res["loss"]),
                                                            unsharded)
