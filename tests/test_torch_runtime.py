"""The port's fault-tolerance substrate (repro_torch.runtime.checkpoint,
runtime.health, data.pipeline) held to the reference's tests
(tests/test_runtime.py), and its checkpoints read across the two packages.

* Checkpoints: round trip, retention and ``latest``, a corrupt newest step
  skipped, a partial write never visible, the async checkpointer (whose
  snapshot training cannot mutate), the shape guard.
* The layout on disk is the reference's: the same leaf paths for the same
  tree (``state_trees`` of the model and ``OptState``), the same manifest,
  and a bf16 leaf written byte for byte as numpy writes the reference's
  ``ml_dtypes`` bfloat16 array.
* Cross-reading at smoke size: a bundle the reference writes restores into
  the port, and a bundle the port writes restores into the reference, leaves
  bit-equal; a reference-written bf16 leaf restores into the port.
* Data determinism and shard failover, failure detection and stragglers:
  the reference's cases on the port's copies.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.registry import build as jax_build  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus, reassign_shard  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime.health import HealthMonitor  # noqa: E402

CPU = torch.device("cpu")


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)),
        "nested": {"b": torch.arange(10, dtype=torch.int32), "c": torch.tensor(3.5)},
    }


def _leaves(tree):
    return ckpt._flatten(tree)[1]


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t, extra={"loss": 1.25})
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, extra = ckpt.restore(str(tmp_path), 5, t)
    assert extra == {"loss": 1.25}
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_retention_and_latest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t, keep=2)
    assert sorted(ckpt.committed_steps(str(tmp_path))) == [4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_corrupt_checkpoint_skipped(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    ckpt.save(str(tmp_path), 2, t)
    d = os.path.join(str(tmp_path), "step_2")
    victim = next(f for f in os.listdir(d) if f.endswith(".npy"))
    os.remove(os.path.join(d, victim))
    assert ckpt.latest_step(str(tmp_path)) == 1  # falls back to the valid one


def test_partial_write_never_visible(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp"))  # a crash mid-save
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_async_checkpointer_snapshots_before_training_mutates(tmp_path):
    t = _tree()
    want = t["a"].clone()
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(3, t)
    t["a"].add_(1.0)  # training updates in place right after save() returns
    ac.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    restored, _ = ckpt.restore(str(tmp_path), 3, t)
    assert torch.equal(restored["a"], want)


def test_restore_dtype_and_shape_guard(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    bad = {"a": torch.zeros((4, 4)), "nested": t["nested"]}
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 1, bad)
    like = {"a": torch.empty((16, 8), dtype=torch.float64, device="meta"),
            "nested": {"b": torch.empty(10, dtype=torch.int64, device="meta"), "c": 0.0}}
    restored, _ = ckpt.restore(str(tmp_path), 1, like)
    assert restored["a"].dtype == torch.float64 and restored["a"].device == CPU
    assert restored["nested"]["b"].dtype == torch.int64 and restored["nested"]["c"] == 3.5


# ---------------------------------------------------------------------------
# the reference's layout, read both ways
# ---------------------------------------------------------------------------


def _reference_state():
    """The reference's smoke model: its init, and an optimizer state with
    nonzero moments and step (one update with made-up gradients)."""
    cfg = jax_smoke("qwen1.5-0.5b")
    params = jax_build(cfg).init(jax.random.PRNGKey(0))
    opt_cfg = jax_opt.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, opt, _ = jax_opt.update(params, grads, jax_opt.init(params, opt_cfg), opt_cfg)
    return jax.device_get(params), jax.device_get(opt)


def _port_state(params_np, opt_np=None):
    """The port's model and optimizer state holding the reference's values."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    model = build(cfg, device=CPU, params=params_from_jax(params_np))
    opt = optimizers.init(list(model.parameters()), optimizers.OptConfig(name=cfg.optimizer))
    if opt_np is not None:
        names = [n for n, _ in model.named_parameters()]

        def get(tree, name):
            for key in name.split("."):
                tree = tree[key]
            return torch.from_numpy(np.asarray(tree).copy())

        opt = optimizers.OptState(step=int(opt_np.step), m=[get(opt_np.m, n) for n in names],
                                  v=[get(opt_np.v, n) for n in names])
    return model, opt


def test_state_trees_have_the_reference_paths():
    params, opt = _reference_state()
    model, port_opt = _port_state(params, opt)
    trees = ckpt.state_trees(model, port_opt)
    for name, ref_tree in (("params", params), ("opt", opt)):
        ref_paths = ["/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in kp)
                     for kp, _ in jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
        assert ckpt._flatten(trees[name])[0] == ref_paths


def test_reference_bundle_restores_into_the_port(tmp_path):
    params, opt = _reference_state()
    jckpt.save_bundle(str(tmp_path), 7, {"params": params, "opt": opt}, {"loss": 2.5})
    model, port_opt = _port_state(jax.tree.map(np.zeros_like, params))
    like = ckpt.state_trees(model, port_opt)
    assert ckpt.latest_step(str(tmp_path)) == 7
    trees, extra = ckpt.restore_bundle(str(tmp_path), 7, like)
    port_opt = ckpt.load_state(model, port_opt, trees)
    assert extra == {"loss": 2.5} and port_opt.step == int(opt.step) == 1
    want_model, want_opt = _port_state(params, opt)
    for got, want in zip(_leaves(ckpt.state_trees(model, port_opt)),
                         _leaves(ckpt.state_trees(want_model, want_opt))):
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype and torch.equal(got.view(torch.int32),
                                                           want.view(torch.int32))
        else:
            assert got == want


def test_port_bundle_restores_into_the_reference(tmp_path):
    params, opt = _reference_state()
    model, port_opt = _port_state(params, opt)
    ckpt.save_bundle(str(tmp_path), 3, ckpt.state_trees(model, port_opt), {"loss": 1.5})
    with open(tmp_path / "step_3" / "manifest.json") as f:
        assert json.load(f) == {"step": 3, "extra": {"loss": 1.5}, "trees": ["opt", "params"]}
    assert jckpt.latest_step(str(tmp_path)) == 3
    zeros = (jax.tree.map(np.zeros_like, params), jax.tree.map(np.zeros_like, opt))
    trees, extra = jckpt.restore_bundle(str(tmp_path), 3, {"params": zeros[0], "opt": zeros[1]})
    assert extra == {"loss": 1.5}
    for name, want in (("params", params), ("opt", opt)):
        got = trees[name]
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(np.asarray(g).reshape(-1).view(np.uint8),
                                          np.asarray(w).reshape(-1).view(np.uint8))


def test_bf16_leaves_written_and_read_as_the_reference_does(tmp_path):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7)).astype(np.float32)
    ref_bf16 = x.astype(ml_dtypes.bfloat16)
    jckpt.save(str(tmp_path / "ref"), 1, {"w": ref_bf16})
    port_bf16 = torch.from_numpy(x).to(torch.bfloat16)
    ckpt.save(str(tmp_path / "port"), 1, {"w": port_bf16})
    files = [(tmp_path / d / "step_1" / "0.npy").read_bytes() for d in ("ref", "port")]
    assert files[0] == files[1]  # the same header ('<V2') and the same words
    manifests = [json.loads((tmp_path / d / "step_1" / "manifest.json").read_text())
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    assert manifests[0]["leaves"]["w"]["dtype"] == "bfloat16"
    like = {"w": torch.empty((3, 7), dtype=torch.bfloat16, device="meta")}
    restored, _ = ckpt.restore(str(tmp_path / "ref"), 1, like)
    assert torch.equal(restored["w"].view(torch.int16), port_bf16.view(torch.int16))


# ---------------------------------------------------------------------------
# data pipeline determinism and failover
# ---------------------------------------------------------------------------


def test_data_deterministic_per_step_and_shard():
    c = SyntheticCorpus(1000, seed=3)
    a = c.batch(7, 2, 4, 64)
    assert np.array_equal(a, c.batch(7, 2, 4, 64))
    assert not np.array_equal(a, c.batch(8, 2, 4, 64))
    assert not np.array_equal(a, c.batch(7, 3, 4, 64))


def test_shard_reassignment_reproduces_lost_stream():
    c = SyntheticCorpus(1000)
    dead = ShardedLoader(c, 16, 32, shard_id=3, num_shards=4)
    survivor = ShardedLoader(c, 16, 32, shard_id=0, num_shards=4)
    replacement = reassign_shard(survivor, new_shard_id=3)
    for step in (0, 5, 11):
        np.testing.assert_array_equal(dead.batch_at(step)["tokens"],
                                      replacement.batch_at(step)["tokens"])
    with pytest.raises(ValueError, match="out of range"):
        reassign_shard(survivor, new_shard_id=4)


# ---------------------------------------------------------------------------
# health / stragglers
# ---------------------------------------------------------------------------


def test_failure_detection_and_reassignment():
    t = [0.0]
    hm = HealthMonitor(hosts=[0, 1, 2, 3], timeout=10.0, clock=lambda: t[0])
    for h in range(4):
        hm.heartbeat(h, 1.0)
    t[0] = 5.0
    for h in (0, 1, 3):
        hm.heartbeat(h, 1.0)
    t[0] = 16.0  # host 2 silent for 16 s > timeout
    for h in (0, 1, 3):
        hm.heartbeat(h, 1.0)
    res = hm.check()
    assert res["dead"] == [2]
    assert res["reassign"] == {2: 0}  # deterministic: lowest surviving id


def test_straggler_detection():
    t = [0.0]
    hm = HealthMonitor(hosts=[0, 1, 2, 3], timeout=100.0, straggler_factor=2.0,
                       clock=lambda: t[0])
    for _ in range(8):
        for h in range(4):
            hm.heartbeat(h, 1.0 if h != 3 else 5.0)  # host 3 is 5x slower
    res = hm.check()
    assert 3 in res["stragglers"] and res["dead"] == []
