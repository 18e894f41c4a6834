"""The paper's Fig. 9 gate on the port: FPISA-A gradient aggregation must not
change training convergence (the reference's
tests/test_convergence.py::test_fpisa_a_training_matches_exact).

The smoke qwen1.5-0.5b cut to 2 layers x d_model 64 trains for 30 steps
over 4 simulated workers with AdamW (lr 3e-3, 5 warm-up steps), once with
the exact float mean of the workers' gradients and once with the port's
switch-arrival FPISA-A sum (``core/fpisa.py::fpisa_sum_sequential``)
divided by 4. Each worker's batch is (2, 32) tokens from
``np.random.default_rng(1000 + step)`` with an 8-token motif from
``default_rng(5)`` at positions 0-8 and 16-24, the reference's layout (its
draws are ``jax.random``'s; these are numpy's, so both curves are the
port's own). The bounds are the reference's: both curves learn (the last
loss below 0.9 x the first) and the mean relative gap over the last 10
steps stays under 0.05.

The aggregation itself is held bit for bit: the four step-0 worker
gradients, fed as numpy to both packages' ``fpisa_sum_sequential``, give
the same bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import fpisa as jf  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import fpisa as tf  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

WORKERS = 4
STEPS = 30
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """The smoke model's ops are tiny: one thread runs them faster than
    many, and keeps their time when parallel test workers share the
    host's cores (the bits are the same)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make(seed=0):
    cfg = get_smoke_config("qwen1.5-0.5b").with_(num_layers=2, d_model=64)
    return cfg, build(cfg, device=CPU, seed=seed)


def _worker_batches(cfg, step):
    toks = np.random.default_rng(1000 + step).integers(0, cfg.vocab_size, (WORKERS, 2, 32))
    # a repeated motif: learnable structure
    motif = np.random.default_rng(5).integers(0, cfg.vocab_size, 8)
    toks[:, :, :8] = motif
    toks[:, :, 16:24] = motif
    return torch.from_numpy(toks)


def _worker_grads(model, params, toks):
    """(mean of the workers' losses, each worker's gradients)."""
    losses, grads = [], []
    for w in range(WORKERS):
        loss = model.loss({"tokens": toks[w]})
        grads.append(torch.autograd.grad(loss, params))
        losses.append(float(loss.detach()))
    return float(np.mean(losses)), grads


def _train(aggregate, seed=0):
    cfg, model = _make(seed)
    params = list(model.parameters())
    opt_cfg = optimizers.OptConfig(name="adamw", lr=3e-3, warmup_steps=5)
    opt = optimizers.init(params, opt_cfg)
    losses = []
    for step in range(STEPS):
        loss, worker_grads = _worker_grads(model, params, _worker_batches(cfg, step))
        grads = [aggregate(gs) for gs in zip(*worker_grads)]
        opt, _ = optimizers.update(params, grads, opt, opt_cfg)
        losses.append(loss)
    return losses


def _agg_exact(gs):
    return sum(gs) / WORKERS


def _agg_fpisa_a(gs):
    stacked = torch.stack([g.reshape(-1) for g in gs]).to(torch.float32)
    out = tf.fpisa_sum_sequential(stacked, variant="fpisa_a")
    return (out / WORKERS).reshape(gs[0].shape).to(gs[0].dtype)


@pytest.mark.slow
def test_fpisa_a_training_matches_exact():
    exact = _train(_agg_exact)
    fpisa = _train(_agg_fpisa_a)
    assert exact[-1] < exact[0] * 0.9, f"baseline didn't learn: {exact}"
    assert fpisa[-1] < fpisa[0] * 0.9, f"fpisa didn't learn: {fpisa}"
    # the curves must track each other (paper Fig. 9)
    diffs = [abs(a - b) / max(abs(a), 1e-6) for a, b in zip(exact, fpisa)]
    assert np.mean(diffs[-10:]) < 0.05, (exact[-5:], fpisa[-5:])


def test_fpisa_a_sum_of_step0_gradients_equals_the_reference():
    cfg, model = _make()
    params = list(model.parameters())
    _, worker_grads = _worker_grads(model, params, _worker_batches(cfg, 0))
    # every leaf's gradients side by side: one (4, N) array
    stacked = torch.stack([torch.cat([g.reshape(-1) for g in gs]) for gs in worker_grads])
    stacked = stacked.to(torch.float32).numpy()
    got = tf.fpisa_sum_sequential(torch.from_numpy(stacked), variant="fpisa_a")
    want = jf.fpisa_sum_sequential(jnp.asarray(stacked), variant="fpisa_a")
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
