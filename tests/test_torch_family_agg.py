"""FPISA aggregation of every family's gradient tree over 2
ranks: the port's Aggregator on 2 gloo processes against the reference's,
fed the same per-worker gradients (the port's, on two halves of a smoke
batch, in the train step's leaf order; for the hybrid also a bf16 model's,
whose float32 ``a_log`` / ``d_skip`` / ``dt_bias`` leaves keep their
format). Bit-exact, leaf by leaf: FPISA is integer arithmetic on the
floats' bits.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro_torch import configs  # noqa: E402
from torch_model_parity import make_batch, torch_batch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY_ARCH = {"dense": "internlm2-20b", "moe": "arctic-480b", "ssm": "mamba2-780m",
               "hybrid": "zamba2-7b", "vlm": "llava-next-34b", "audio": "whisper-medium"}

AGG_TORCH = """
import os, numpy as np, torch, torch.distributed as dist
from repro_torch.core.agg import AggConfig, Aggregator
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method={init!r}, rank=rank, world_size=2)
inp = np.load({inp!r})
bf16 = {bf16!r}
tree = {{k: torch.from_numpy(inp[k][rank]).to(torch.bfloat16 if k in bf16 else torch.float32)
         for k in inp.files}}
out = Aggregator(AggConfig(strategy="fpisa", backend="torch")).allreduce_tree(tree)
np.savez(os.environ["OUT"], **{{k: v.to(torch.float32).numpy() for k, v in out.items()}})
dist.destroy_process_group()
"""


def test_fpisa_aggregation_of_every_family_bit_exact(tmp_path):
    """Each family's per-worker gradients (the port's, on two halves of a
    batch; for the hybrid also a bf16 model's, whose float32 leaves keep
    their format), in the train step's leaf order, through the port's
    Aggregator on 2 gloo ranks and through the reference's Aggregator over
    a 2-wide named axis (``jax.vmap(axis_name=...)``: its pmax and psum over
    the two workers, on one device): the same bits, leaf by leaf."""
    from jax.numpy import bfloat16
    from repro.core.agg import AggConfig as JaxAggConfig
    from repro.core.agg import Aggregator as JaxAggregator
    from repro_torch.models.registry import build

    inp, bf16 = {}, []
    runs = [(f, a, {}) for f, a in FAMILY_ARCH.items()]
    runs.append(("hybrid-bf16", "zamba2-7b",
                 {"param_dtype": "bfloat16", "activation_dtype": "bfloat16"}))
    for tag, arch, kw in runs:
        model = build(configs.get_smoke_config(arch).with_(**kw), device=torch.device("cpu"))
        batch = torch_batch(make_batch(model.cfg, 4, 32, seed=8))
        names, params = zip(*model.named_parameters())
        grads = [torch.autograd.grad(model.loss({k: v[2 * w:2 * w + 2] for k, v in batch.items()}),
                                     params) for w in range(2)]
        for name, g0, g1 in zip(names, *grads):
            key = f"{tag}/{name}"
            inp[key] = torch.stack([g0, g1]).to(torch.float32).numpy()
            if g0.dtype == torch.bfloat16:
                bf16.append(key)
    path = str(tmp_path / "grads.npz")
    np.savez(path, **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    code = AGG_TORCH.format(init=f"file://{tmp_path}/pg", inp=path, bf16=bf16)
    outs = [str(tmp_path / f"torch{r}.npz") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=dict(env, RANK=str(r), OUT=outs[r])) for r in range(2)]
    try:
        tree = {k: jax.numpy.asarray(v, bfloat16 if k in bf16 else np.float32)
                for k, v in inp.items()}
        agg = JaxAggregator(JaxAggConfig(strategy="fpisa", backend="jnp"), ("data",))
        want = jax.jit(jax.vmap(agg.allreduce_tree, axis_name="data"))(tree)
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for out in outs:
        got = dict(np.load(out))
        assert set(got) == set(inp)
        for key in inp:
            w = np.asarray(want[key][0], np.float32)
            np.testing.assert_array_equal(got[key].view(np.int32), w.view(np.int32),
                                          err_msg=key)
