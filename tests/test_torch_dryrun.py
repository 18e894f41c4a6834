"""The port's dry run and op scan (repro_torch.launch.dryrun,
launch/opscan.py) against the JAX reference's (repro.launch.dryrun,
launch/hloscan.py).

``repro.launch.dryrun`` sets ``XLA_FLAGS`` in its first lines, and the
port's dry run replaces the default process group with a ``fake`` one, so
both run in subprocesses of their own.

* ``model_flops`` and ``active_param_count`` equal the reference's for every
  architecture and shape (exact: the same integer arithmetic).
* ``_wire_factor`` equals hloscan's for every collective kind and group
  size.
* The CLI prints one JSON line per cell with the reference's keys (a
  2-layer qwen1.5-0.5b at full width on the (16, 16) mesh): the train cell
  ``ok`` with ``per_device`` (``arg_bytes`` the sum of rank 0's shards),
  ``roofline{compute_s, memory_s, collective_s, bottleneck}``,
  ``model_flops_global``, ``useful_flops_ratio`` and
  ``collectives_by_kind``; the prefill_32k and decode_32k cells ``ok``
  too; ``long_500k`` skipped with the reference's reason.
* opscan's product flops for a smoke qwen1.5-0.5b train step (native
  aggregation, one process) are held to the reference's ``hloscan.analyze``
  flops of the same step: equal to hloscan's dot flops (its count with the
  elementwise opcodes left out), exactly, since the port's chunked
  attention runs the reference's (q, kv) chunk pairs and the reference's
  recompute of the scores; hloscan's total counts XLA's elementwise work
  on top of them (the optimizer's update, the softmaxes), 5.4 % here, and
  opscan's own total (products + its elementwise count) is within 2 % of
  hloscan's (1.9 % here).
* opscan counts collectives on a fake group of 8 ranks with hloscan's ring
  factors: all-reduce 2(k-1)/k, all-gather (k-1)/k of the gathered
  output, reduce-scatter (k-1) times the scattered output.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import hloscan  # noqa: E402  (no jax at import)
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun, opscan  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF_CODE = r"""
import json
import jax, jax.numpy as jnp
from repro.launch import dryrun, hloscan
from repro.configs import ARCH_NAMES, SHAPES, get_config, get_smoke_config
from repro import compat
from repro.core.agg import AggConfig
from repro.models.registry import build
from repro.optim import optimizers
from repro.train.step import make_train_step
out = {"flops": {a: {s: [dryrun.model_flops(get_config(a), sh),
                         dryrun.active_param_count(get_config(a))]
                     for s, sh in SHAPES.items()} for a in ARCH_NAMES}}
cfg = get_smoke_config("qwen1.5-0.5b")
model = build(cfg)
params = model.init(jax.random.PRNGKey(0))
opt_cfg = optimizers.OptConfig(name=cfg.optimizer)
opt = optimizers.init(params, opt_cfg)
mesh = compat.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
step = make_train_step(model, mesh, AggConfig(strategy="native"), opt_cfg, 4)
batch = {"tokens": jnp.zeros((4, 64), jnp.int32)}
hlo = jax.jit(step).lower(params, opt, batch).compile().as_text()
out["hloscan_flops"] = hloscan.analyze(hlo, 1).flops
hloscan.ELEMENTWISE_FLOP = frozenset()  # the dots alone (this process only)
out["hloscan_dot_flops"] = hloscan.analyze(hlo, 1).flops
print(json.dumps(out))
"""

COLL_CODE = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
import torch.distributed._functional_collectives as fc
from repro_torch.launch import opscan
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
g = dist.new_group(list(range(8)))
x = torch.zeros(1024, dtype=torch.float32)
with opscan.OpScan() as sc:
    fc.all_reduce(x, "sum", g).wait()
    fc.all_gather_tensor(x, 0, g).wait()
    fc.reduce_scatter_tensor(x, "sum", 0, g).wait()
    dist.all_reduce(x, group=g)
print(json.dumps(sc.analysis.collectives))
"""


def _run(code=None, args=None, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-c", code] if code else [sys.executable, "-m", *args]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


@pytest.fixture(scope="module")
def ref():
    return json.loads(_run(REF_CODE).strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_equal_reference(ref, arch):
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        want_flops, want_n = ref["flops"][arch][name]
        assert dryrun.model_flops(cfg, shape) == want_flops, name
        assert dryrun.active_param_count(cfg) == want_n


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_factor_equals_hloscan(kind):
    for k in (2, 4, 16, 256):
        assert opscan._wire_factor(kind, 1000.0, k) == hloscan._wire_factor(kind, 1000.0, k)


def test_opscan_products_match_hloscan(ref):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.models.registry import build
    from repro_torch.optim import optimizers
    from repro_torch.train.step import make_train_step

    cfg = get_smoke_config("qwen1.5-0.5b")
    model = build(cfg, device=torch.device("cpu"), seed=0)
    opt_cfg = optimizers.OptConfig(name=cfg.optimizer)
    opt = optimizers.init(list(model.parameters()), opt_cfg)
    step = make_train_step(model, AggConfig(strategy="native"), opt_cfg, 4)
    batch = {"tokens": torch.zeros((4, 64), dtype=torch.int64)}
    _, an = opscan.analyze(step, opt, batch)
    want = ref["hloscan_flops"]
    assert an.product_flops == ref["hloscan_dot_flops"] <= want, (an.product_flops, ref)
    assert abs(an.flops - want) <= 0.02 * want, (an.flops, want)


def test_opscan_counts_collectives_with_ring_factors():
    got = json.loads(_run(COLL_CODE).strip().splitlines()[-1])
    size = 1024 * 4
    assert got["all-reduce"] == {"count": 2.0, "wire": 2 * size * 2 * 7 / 8}
    assert got["all-gather"] == {"count": 1.0, "wire": 8 * size * 7 / 8}
    assert got["reduce-scatter"] == {"count": 1.0, "wire": size / 8 * 7}


def test_cli_prints_the_reference_keys():
    out = _run(args=["repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b", "--shape", "all",
                     "--override", "num_layers=2"])
    recs = {r["shape"]: r for r in map(json.loads, out.strip().splitlines())}
    assert set(recs) == set(SHAPES)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert recs[shape]["status"] == "ok", recs[shape].get("error")
    train = recs["train_4k"]
    assert train["mesh"] == {"data": 16, "model": 16}
    assert set(train["roofline"]) == {"compute_s", "memory_s", "collective_s", "bottleneck"}
    for key in ("per_device", "model_flops_global", "useful_flops_ratio", "collectives_by_kind"):
        assert key in train
    cfg = get_config("qwen1.5-0.5b").with_(num_layers=2)
    assert train["model_flops_global"] == dryrun.model_flops(cfg, SHAPES["train_4k"])
    # rank 0's shards: the (16, 16) placement of the 2-layer model, its
    # float32 moments (ZeRO-1 over 'data') and its 16 rows of 4096 tokens
    assert 0 < train["per_device"]["arg_bytes"] < 2 * 2 * 463_987_712 / 16
    assert train["per_device"]["op_product_flops"] > 0
    assert recs["long_500k"]["status"] == "skipped"
    assert "sub-quadratic" in recs["long_500k"]["reason"]
