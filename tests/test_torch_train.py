"""The port's training path against the JAX reference, at smoke size:
qwen1.5-0.5b-smoke in float32, global batch 4, seq 64, FPISA aggregation,
both sides starting from the SAME weights (the JAX init, carried over with
repro_torch.interop.params_from_jax).

* Loss and grad norm per step, over 3 steps, against the reference's
  1-device make_train_step (backend jnp). Tolerances: float32 forward and
  backward in two frameworks differ only in summation order and in the
  transcendental functions (exp, rsqrt, log), a few ulp per op; the
  reference also streams attention in (q, kv) chunks with an online softmax
  where the port takes one softmax. Step 0 (same weights, same tokens) is
  held to 2e-6 relative; the later steps, whose weights have moved through
  the FPISA-quantized AdamW update, to 2e-5. The grad norm is held to 2e-5.
* The same 3 steps with the switch-arrival ``fpisa_seq`` aggregation,
  against the reference's step with ``fpisa_seq``, same tolerances.
* When the reference's gradients are fed into both aggregators, the
  aggregated gradients are BIT-EXACT (integer views).
* ``accum_steps=2`` (two microbatches, float32 gradient accumulation)
  against the reference's step with ``accum_steps=2``, same tolerances.
* Bucketed aggregation in the train step: the aggregated gradients, and so
  the losses and weights of 3 steps, equal the per-leaf step's bit for bit;
  the reference's gradients bucketed equal the reference's aggregation.
* The CLI, ``python -m repro_torch.launch.train --device cpu --smoke``,
  runs and prints its loss lines, with ``--agg fpisa``, ``fpisa_seq`` and
  ``switch_emu``, and with ``--bucket-bytes auto --trace-out``, whose file
  ``repro.trace.read_jsonl`` reads.
"""
import os
import re
import subprocess
import sys

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
from repro_torch.core.agg import AggConfig, Aggregator  # noqa: E402
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus  # noqa: E402
from repro_torch.interop import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, STEPS, BATCH, SEQ = "qwen1.5-0.5b", 3, 4, 64


def _jax_steps(model, params, mesh, agg, opt_cfg, loader, accum_steps=1):
    """STEPS reference steps from ``params``: (losses, grad norms)."""
    step = jax.jit(jax_make_train_step(model, mesh, agg, opt_cfg, BATCH,
                                       accum_steps=accum_steps))
    opt_state = jax_opt.init(params, opt_cfg)
    losses, gnorms = [], []
    for i in range(STEPS):
        params, opt_state, metrics = step(
            params, opt_state, {"tokens": jnp.asarray(loader.batch_at(i)["tokens"])})
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    return losses, gnorms


@pytest.fixture(scope="module")
def reference():
    """The JAX run: initial weights (numpy), per-step loss / grad norm with
    fpisa and with fpisa_seq aggregation, and the step-0 gradients before
    and after the FPISA aggregation."""
    cfg = jax_smoke(ARCH)
    model = jax_build(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    mesh = make_mesh_for(jax.devices()[:1])
    agg = JaxAggConfig(strategy="fpisa", backend="jnp")
    opt_cfg = jax_opt.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
    loader = JaxLoader(JaxCorpus(cfg.vocab_size, 0), BATCH, SEQ)
    batch0 = {"tokens": jnp.asarray(loader.batch_at(0)["tokens"])}

    grads = jax.jit(jax.grad(model.loss))(params, batch0)
    aggregator = JaxAggregator(agg, ("data",))
    agg_fn = jax.jit(compat.shard_map(aggregator.allreduce_tree, mesh=mesh, in_specs=(P(),),
                                      out_specs=P(), axis_names={"data"}))
    agg_grads = agg_fn(grads)

    losses, gnorms = _jax_steps(model, params, mesh, agg, opt_cfg, loader)
    seq = _jax_steps(model, params, mesh, JaxAggConfig(strategy="fpisa_seq"), opt_cfg, loader)
    accum = _jax_steps(model, params, mesh, agg, opt_cfg, loader, accum_steps=2)
    return {"init": init, "losses": losses, "gnorms": gnorms, "seq": seq, "accum": accum,
            "grads": jax.tree.map(np.asarray, grads),
            "agg_grads": jax.tree.map(np.asarray, agg_grads)}


def _port_model(reference):
    return build(get_smoke_config(ARCH), device=torch.device("cpu"),
                 params=params_from_jax(reference["init"]))


def test_weights_carry_across_in_the_reference_layout(reference):
    model = _port_model(reference)
    back = params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(reference["init"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(reference["init"])):
        np.testing.assert_array_equal(a, b)
    # named_parameters() walks the leaves in the reference's flatten order
    ref_paths = ["/".join(k.key for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(reference["init"])[0]]
    assert [n.replace(".", "/") for n, _ in model.named_parameters()] == ref_paths
    assert len(ref_paths) == 14


def _port_steps(reference, strategy, model=None, **step_kw):
    cfg = get_smoke_config(ARCH)
    model = model or _port_model(reference)
    opt_cfg = optimizers.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
    agg = AggConfig(strategy=strategy, bucket_bytes=step_kw.pop("bucket_bytes", 0))
    step = make_train_step(model, agg, opt_cfg, BATCH, **step_kw)
    opt_state = optimizers.init(list(model.parameters()), opt_cfg)
    loader = ShardedLoader(SyntheticCorpus(cfg.vocab_size, 0), BATCH, SEQ)
    losses, gnorms = [], []
    for i in range(STEPS):
        opt_state, metrics = step(opt_state,
                                  {"tokens": torch.from_numpy(loader.batch_at(i)["tokens"])})
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    return losses, gnorms


def test_loss_and_grad_norm_track_the_reference(reference):
    losses, gnorms = _port_steps(reference, "fpisa")
    np.testing.assert_allclose(losses[0], reference["losses"][0], rtol=2e-6)
    np.testing.assert_allclose(losses, reference["losses"], rtol=2e-5)
    np.testing.assert_allclose(gnorms, reference["gnorms"], rtol=2e-5)
    assert losses[-1] < losses[0]


def test_fpisa_seq_loss_tracks_the_reference(reference):
    """Switch-arrival aggregation on the CPU (one worker, torch backend)
    against the reference's 1-device step with fpisa_seq; the tolerances
    of the fpisa case."""
    losses, gnorms = _port_steps(reference, "fpisa_seq")
    ref_losses, ref_gnorms = reference["seq"]
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=2e-6)
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-5)
    np.testing.assert_allclose(gnorms, ref_gnorms, rtol=2e-5)
    assert losses[-1] < losses[0]


def test_accum_steps_loss_tracks_the_reference(reference):
    """Two microbatches of 2, float32 accumulation, against the reference's
    step with accum_steps=2; the tolerances of the fpisa case."""
    losses, gnorms = _port_steps(reference, "fpisa", accum_steps=2)
    ref_losses, ref_gnorms = reference["accum"]
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=2e-6)
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-5)
    np.testing.assert_allclose(gnorms, ref_gnorms, rtol=2e-5)
    assert losses[-1] < losses[0]
    with pytest.raises(ValueError, match="accum_steps=3"):
        _port_steps(reference, "fpisa", accum_steps=3)


@pytest.mark.parametrize("strategy", ["fpisa", "fpisa_seq"])
def test_bucketed_train_step_equals_per_leaf(reference, strategy, monkeypatch):
    """The step's aggregated gradients are the per-leaf step's, bit for bit,
    so 3 steps end on the same losses, grad norms and weights."""
    from repro_torch.core import agg as tagg

    seen = {}
    real = tagg.Aggregator.allreduce_tree

    def keep(self, tree):
        out = real(self, tree)
        seen.setdefault(self.cfg.bucket_bytes, []).append(
            {k: v.clone() for k, v in out.items()})
        return out

    monkeypatch.setattr(tagg.Aggregator, "allreduce_tree", keep)
    models = {bb: _port_model(reference) for bb in (0, 4096)}
    runs = {bb: _port_steps(reference, strategy, model=m, bucket_bytes=bb)
            for bb, m in models.items()}
    assert runs[0] == runs[4096]
    for a, b in zip(seen[0], seen[4096]):
        for k in a:
            assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), k
    for p, q in zip(models[0].parameters(), models[4096].parameters()):
        assert torch.equal(p, q)


def test_port_gradients_match_the_reference(reference):
    """Same weights, same tokens: the port's autograd gradients agree with
    jax.grad to float32 rounding (stated: 1e-5 of each leaf's largest
    entry)."""
    cfg = get_smoke_config(ARCH)
    model = _port_model(reference)
    tokens = ShardedLoader(SyntheticCorpus(cfg.vocab_size, 0), BATCH, SEQ).batch_at(0)["tokens"]
    loss = model.loss({"tokens": torch.from_numpy(tokens)})
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    ref = jax.tree.leaves(reference["grads"])
    for name, g, r in zip(names, grads, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("backend_path", ["torch", "cuda-composition"])
def test_aggregated_reference_gradients_bit_exact(reference, backend_path, monkeypatch):
    """The reference's step-0 gradients through both aggregators (FPISA,
    fp32, 32-bit wire, one worker): bit-exact. The second case runs the
    cuda backend's composition (kernel wrappers, plain versions on CPU)."""
    if backend_path != "torch":
        from repro_torch.core import allreduce

        monkeypatch.setattr(allreduce, "resolve_backend", lambda backend, device: "cuda")
    tree = params_from_jax(reference["grads"])
    want = jax.tree.leaves(reference["agg_grads"])
    for bucket_bytes in (0, 4096, 1 << 20):  # per leaf, then bucketed
        cfg = AggConfig(strategy="fpisa", backend="auto", bucket_bytes=bucket_bytes)
        out = Aggregator(cfg).allreduce_tree(tree)
        got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), out))
        assert len(got) == len(want) == 14
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def _run_cli(agg, *extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("REPRO_AUTOTUNE_TRACE", None)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", ARCH,
         "--smoke", "--steps", "3", "--global-batch", "4", "--seq-len", "64", "--agg", agg,
         *extra],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = re.findall(r"\[train\] step +(\d+) loss ([\d.]+) gnorm ([\d.]+) [\d,]+ tok/s",
                       res.stdout)
    assert [int(s) for s, _, _ in lines] == [0, 2]
    assert all(np.isfinite(float(v)) for _, v, _ in lines)
    return [float(v) for _, v, _ in lines]


def test_cli_runs_on_cpu_and_prints_loss_lines():
    _run_cli("fpisa")


def test_cli_runs_switch_strategies_on_cpu():
    """--agg switch_emu runs the numpy dataplane and prints the losses of
    --agg fpisa_seq (the two aggregate to the same bits)."""
    assert _run_cli("switch_emu") == _run_cli("fpisa_seq")


def test_cli_bucketed_auto_traced_run(tmp_path):
    """--bucket-bytes auto (no autotune trace: the warned fallback) with
    --trace-out: the same losses as per leaf, and a trace file the
    reference's reader takes, holding the bucketer's phase spans."""
    from repro import trace as jtrace

    path = tmp_path / "t.jsonl"
    assert _run_cli("fpisa", "--bucket-bytes", "auto", "--trace-out", str(path)) \
        == _run_cli("fpisa", "--agg-chunk", "512")
    _, spans = jtrace.read_jsonl(path)
    names = {s["name"] for s in spans}
    assert {"bucketer.encode", "bucketer.collective", "bucketer.finish",
            "agg.allreduce_tree"} <= names
    assert all(s["synced"] for s in spans if s["name"].startswith("bucketer."))


def test_cli_refuses_unported_flags(tmp_path, capsys):
    """--ckpt-dir, --fault-plan and --num-hosts are ported
    (tests/test_torch_recovery.py); the launcher refuses what the
    reference's refuses on that path: --agg-chunk with the controller, more
    hosts than ranks, a fault plan naming a host outside the job."""
    from repro_torch.launch.train import main

    for extra, why in ((["--fault-plan", "kill:1@2", "--agg-chunk", "512"], "--agg-chunk"),
                       (["--num-hosts", "2"], "exceeds the 1 ranks"),
                       (["--fault-plan", "kill:5@2"], "host 5")):
        with pytest.raises(SystemExit):
            main(["--device", "cpu", "--arch", ARCH, "--smoke", "--steps", "1",
                  "--ckpt-dir", str(tmp_path), *extra])
        assert why in capsys.readouterr().err
