"""The port's elastic runtime (repro_torch.runtime.controller, health,
elastic, checkpoint bundles, the launcher's --ckpt-dir / --fault-plan) held
to the reference's tests (tests/test_recovery.py), on the CPU.

1. Control plane: HealthMonitor revival retracts the shard reassignment,
   the windowed straggler detector ignores one-off pauses but flags a
   degraded host, a bad data group raises ValueError, fault plans parse.
2. Checkpoints: a crash mid-save (torn bundle) is never visible; params and
   opt commit in one rename; ``train_loop`` resumes a legacy split layout,
   and a checkpointed resume gives the uninterrupted run's losses and
   weights bit for bit; the controller owns its directory and refuses a
   fault plan naming a host outside the job, and more hosts than ranks.
3. End to end on 4 gloo ranks (one spawn, every rank a host): a run with an
   injected death resumes on the survivors and its loss history is
   BIT-identical to the uninterrupted run, for bucketed fpisa and for the
   switch_emu protocol emulation; a revival grows the mesh back to 4 hosts;
   recovery reclaims switch slots and leaves none stale; the dead host's
   shard is regenerated bit for bit by its replacement. The launcher drives
   the same path under torchrun.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.agg import AggConfig  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime.controller import (ElasticController, FaultEvent,  # noqa: E402
                                            parse_fault_plan, run_controller)
from repro_torch.runtime.elastic import make_data_group  # noqa: E402
from repro_torch.runtime.health import HealthMonitor  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SMOKE = get_smoke_config("qwen1.5-0.5b")


# ---------------------------------------------------------------------------
# 1. health: revival retraction, windowed stragglers; groups; fault plans
# ---------------------------------------------------------------------------


def _monitor(timeout=10.0, **kw):
    t = [0.0]
    hm = HealthMonitor(hosts=[0, 1, 2, 3], timeout=timeout, clock=lambda: t[0], **kw)
    return hm, t


def test_revival_retracts_reassignment():
    hm, t = _monitor()
    for h in range(4):
        hm.heartbeat(h, 1.0)
    t[0] = 20.0
    for h in (0, 1, 3):
        hm.heartbeat(h, 1.0)
    res = hm.check()
    assert res["dead"] == [2] and hm.reassignments == {2: 0}
    hm.heartbeat(2, 1.0)  # host 2 comes back: the reassignment is retracted
    assert hm.hosts[2].alive and hm.reassignments == {}
    res = hm.check()
    assert res["dead"] == [] and res["reassign"] == {} and hm.reassignments == {}


def test_dead_replacement_is_rerouted():
    hm, t = _monitor()
    for h in range(4):
        hm.heartbeat(h, 1.0)
    t[0] = 20.0
    for h in (1, 2, 3):
        hm.heartbeat(h, 1.0)
    assert hm.check()["dead"] == [0] and hm.reassignments == {0: 1}
    t[0] = 40.0
    for h in (2, 3):
        hm.heartbeat(h, 1.0)
    assert hm.check()["dead"] == [1]
    # shard 0's replacement (host 1) died: both shards land on survivors
    assert hm.reassignments[0] == 2 and hm.reassignments[1] == 2


def test_gc_pause_does_not_flag_straggler():
    hm, _ = _monitor(timeout=1e9)
    for _ in range(8):
        for h in range(4):
            hm.heartbeat(h, 1.0)
    hm.heartbeat(0, 9.0)  # one pause on host 0
    assert hm.check()["stragglers"] == []


def test_degrading_host_flagged_against_peers():
    hm, _ = _monitor(timeout=1e9)
    for i in range(12):
        for h in range(4):
            hm.heartbeat(h, 6.0 if h == 3 and i >= 8 else 1.0)
    assert hm.check()["stragglers"] == [3]


def test_straggler_tiny_sample_guard():
    hm, _ = _monitor(timeout=1e9)
    hm.heartbeat(0, 50.0)  # a single sample is not enough evidence
    hm.heartbeat(1, 1.0)
    assert hm.check()["stragglers"] == []


def test_silent_host_window_not_read_as_straggling():
    hm, t = _monitor(timeout=10.0)
    for i in range(8):
        t[0] = float(i)
        for h in range(4):
            hm.heartbeat(h, 8.0 if i < 2 else 1.0)  # everyone's first steps are slow
    for i in range(8, 14):  # host 0 goes silent
        t[0] = float(i)
        for h in (1, 2, 3):
            hm.heartbeat(h, 1.0)
    res = hm.check()
    assert res["stragglers"] == [] and res["dead"] == []


def test_revival_clears_stale_step_times():
    hm, t = _monitor(timeout=10.0)
    for i in range(6):
        t[0] = float(i)
        for h in range(4):
            hm.heartbeat(h, 5.0 if h == 0 else 1.0)  # host 0 slow, then dies
    t[0] = 30.0
    for h in (1, 2, 3):
        hm.heartbeat(h, 1.0)
    assert hm.check()["dead"] == [0]
    hm.heartbeat(0, 1.0)  # revival drops the pre-outage era
    assert len(hm.hosts[0].step_times) == 1
    for _ in range(4):
        for h in range(4):
            hm.heartbeat(h, 1.0)
    assert hm.check()["stragglers"] == []


def test_make_data_group_raises_value_error():
    assert make_data_group([0]) is None  # no process group: a world of one
    for ranks in ([], [0, 0], [0, 1]):
        with pytest.raises(ValueError, match="rank"):
            make_data_group(ranks)


def test_parse_fault_plan():
    plan = parse_fault_plan("kill:2@5, revive:2@9,slow:3@4x6")
    assert plan == (FaultEvent(4, "slow", 3, 6.0), FaultEvent(5, "kill", 2),
                    FaultEvent(9, "revive", 2))
    assert parse_fault_plan("") == () and parse_fault_plan(None) == ()
    with pytest.raises(ValueError):
        parse_fault_plan("explode:1@2")
    with pytest.raises(ValueError):
        parse_fault_plan("kill:1")


# ---------------------------------------------------------------------------
# 2. checkpoints, train_loop resume, controller set-up
# ---------------------------------------------------------------------------


def _bundle_trees():
    return {"params": {"w": torch.arange(8.0)}, "opt": {"m": torch.zeros(8)}}


def test_crash_mid_checkpoint_restores_previous_step(tmp_path):
    d = str(tmp_path)
    trees = _bundle_trees()
    ckpt.save_bundle(d, 1, trees, {"loss": 1.0})
    ckpt.save_bundle(d, 2, trees, {"loss": 0.9})
    os.makedirs(os.path.join(d, "step_3.tmp", "params"))  # crash mid-save of step 3
    assert ckpt.latest_step(d) == 2
    ckpt.save_bundle(d, 4, trees)  # torn: params landed, opt manifest missing
    os.remove(os.path.join(d, "step_4", "opt", "manifest.json"))
    assert ckpt.latest_step(d) == 2
    ckpt.save_bundle(d, 5, trees)  # the opt manifest, but a missing leaf file
    victim = next(f for f in os.listdir(os.path.join(d, "step_5", "opt"))
                  if f.endswith(".npy"))
    os.remove(os.path.join(d, "step_5", "opt", victim))
    assert ckpt.latest_step(d) == 2
    restored, extra = ckpt.restore_bundle(d, 2, trees)
    assert extra == {"loss": 0.9}
    assert torch.equal(restored["params"]["w"], torch.arange(8.0))


def test_bundle_commit_is_all_or_nothing(tmp_path):
    d = str(tmp_path)
    trees = _bundle_trees()
    ckpt.save_bundle(d, 7, trees)
    with open(os.path.join(d, "step_7", "manifest.json")) as f:
        assert json.load(f)["trees"] == ["opt", "params"]
    out, _ = ckpt.restore_bundle(d, 7, trees)
    assert set(out) == {"params", "opt"}
    ckpt.save(d + "/flat", 1, trees["params"])
    with pytest.raises(ValueError, match="not a bundle"):
        ckpt.restore_bundle(d + "/flat", 1, trees)


def test_train_loop_restores_legacy_split_layout(tmp_path):
    """A directory in the pre-bundle layout (params at <dir>, opt at
    <dir>_opt) resumes instead of failing on restore_bundle."""
    model = build(SMOKE, device=CPU)
    opt = optimizers.init(list(model.parameters()), optimizers.OptConfig(name=SMOKE.optimizer))
    trees = ckpt.state_trees(model, opt)
    d = str(tmp_path / "ck")
    ckpt.save(d, 4, trees["params"])
    ckpt.save(d + "_opt", 4, trees["opt"])
    _, _, hist = train_loop(SMOKE, steps=6, global_batch=4, seq_len=32, device="cpu",
                            ckpt_dir=d, ckpt_every=50, log_every=100)
    assert len(hist) == 1  # resumed at step 5


def test_checkpointed_resume_is_bit_identical(tmp_path):
    """2 steps with a bundle after each, then a resume to step 3: the
    resumed step's loss and every weight equal the uninterrupted run's."""
    kw = dict(global_batch=4, seq_len=32, device="cpu", log_every=100,
              agg=AggConfig(strategy="fpisa", bucket_bytes=4096))
    d = str(tmp_path / "ck")
    train_loop(SMOKE, steps=2, ckpt_dir=d, ckpt_every=1, **kw)
    assert ckpt.latest_step(d) == 1
    resumed, opt_r, hist_r = train_loop(SMOKE, steps=3, ckpt_dir=d, ckpt_every=1, **kw)
    whole, opt_w, hist_w = train_loop(SMOKE, steps=3, **kw)
    assert len(hist_r) == 1 and np.float32(hist_r[0]) == np.float32(hist_w[2])
    assert opt_r.step == opt_w.step == 3
    for a, b in zip(resumed.parameters(), whole.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(opt_r.m + opt_r.v, opt_w.m + opt_w.v):
        assert torch.equal(a, b)


def test_controller_resets_preexisting_ckpt_dir(tmp_path):
    d = str(tmp_path)
    ckpt.save_bundle(d, 40, _bundle_trees())  # a stale high-step bundle
    ElasticController(SMOKE, steps=1, global_batch=4, seq_len=16,
                      agg=AggConfig(strategy="fpisa"), num_hosts=1, ckpt_dir=d,
                      log_every=100, device="cpu")
    assert ckpt.committed_steps(d) == []
    with pytest.raises(ValueError, match="host 5"):
        ElasticController(SMOKE, steps=1, global_batch=4, seq_len=16,
                          agg=AggConfig(strategy="fpisa"), num_hosts=1, ckpt_dir=d,
                          fault_plan="kill:5@0", log_every=100, device="cpu")
    with pytest.raises(ValueError, match="num_hosts=2 exceeds the 1 ranks"):
        ElasticController(SMOKE, steps=1, global_batch=4, seq_len=16,
                          agg=AggConfig(strategy="fpisa"), num_hosts=2, ckpt_dir=d,
                          device="cpu")
    with pytest.raises(ValueError, match="chunk_elems is not supported with stacked"):
        ElasticController(SMOKE, steps=1, global_batch=4, seq_len=16,
                          agg=AggConfig(strategy="fpisa", chunk_elems=256), num_hosts=1,
                          ckpt_dir=d, device="cpu")


def test_one_host_controller_equals_train_loop(tmp_path):
    """One host, one logical worker: the stacked step at k = 1 is the flat
    step, so the controller's history is train_loop's, bit for bit."""
    agg = AggConfig(strategy="fpisa")
    out = run_controller(SMOKE, steps=3, global_batch=4, seq_len=32, agg=agg, num_hosts=1,
                         ckpt_dir=str(tmp_path), ckpt_every=1, log_every=100, device="cpu")
    _, _, hist = train_loop(SMOKE, steps=3, global_batch=4, seq_len=32, agg=agg,
                            device="cpu", log_every=100)
    assert out["history"] == [float(np.float32(v)) for v in hist]
    assert out["recoveries"] == [] and out["mesh_hosts"] == [0]
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_controller_removes_its_own_ckpt_dir(tmp_path, monkeypatch):
    """Without ckpt_dir the controller checkpoints into a temporary
    directory of its own and removes it when run() ends; a directory the
    caller gave is kept."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = run_controller(SMOKE, steps=2, global_batch=4, seq_len=16, num_hosts=1,
                         ckpt_every=1, log_every=100, device="cpu")
    assert len(out["history"]) == 2
    assert os.listdir(tmp_path) == []
    kept = str(tmp_path / "kept")
    run_controller(SMOKE, steps=2, global_batch=4, seq_len=16, num_hosts=1, ckpt_dir=kept,
                   ckpt_every=1, log_every=100, device="cpu")
    assert ckpt.latest_step(kept) == 2


# ---------------------------------------------------------------------------
# 3. end to end: kill-and-resume == uninterrupted, 4 gloo ranks
# ---------------------------------------------------------------------------

RECOVERY_CODE = r"""
import json, os, tempfile
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.core.agg import AggConfig
from repro_torch import trace
from repro_torch.runtime.controller import ElasticController
torch.set_num_threads(1)
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank, world_size=4)
tmp = os.environ["TMP"]

def run(cfg, agg, fault, steps, tag, **kw):
    ctl = ElasticController(cfg, steps=steps, global_batch=8, seq_len=32, agg=agg,
                            ckpt_dir=os.path.join(tmp, tag), ckpt_every=3, fault_plan=fault,
                            log_every=1000, device="cpu", **kw)
    return ctl, ctl.run()

res = {}
cfg = get_smoke_config("qwen1.5-0.5b")
agg = AggConfig(strategy="fpisa", bucket_bytes=1 << 16)
res["base"] = run(cfg, agg, "", 14, "base")[1]
res["kill"] = run(cfg, agg, "kill:2@4", 10, "kill")[1]
tracer = trace.enable()
res["revive"] = run(cfg, agg, "kill:2@4,revive:2@9", 14, "revive")[1]
trace.disable()
res["span_names"] = sorted({s["name"] for s in tracer.spans})
tiny = cfg.with_(name="tiny", num_layers=1, d_model=16, num_heads=2, num_kv_heads=2,
                 d_ff=32, vocab_size=64)
agge = AggConfig(strategy="switch_emu")
res["emu_base"] = run(tiny, agge, "", 8, "emu_base")[1]
res["emu_kill"] = run(tiny, agge, "kill:3@3", 8, "emu_kill")[1]
ctl = ElasticController(cfg, steps=8, global_batch=8, seq_len=32, agg=AggConfig(strategy="fpisa"),
                        ckpt_dir=os.path.join(tmp, "reassign"), ckpt_every=3,
                        fault_plan="kill:3@2", log_every=1000, device="cpu")
before = ctl._global_tokens(7).copy()
res["reassign"] = ctl.run()
res["reassign_owner"] = [ctl._shard_owner[3], ctl.health.reassignments.get(3)]
res["reassign_same_batch"] = bool(np.array_equal(before, ctl._global_tokens(7)))
with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def recovery(tmp_path_factory):
    """Every controller run of this section, on 4 gloo ranks at once.
    Returns the results of each rank."""
    tmp = tmp_path_factory.mktemp("recovery")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""), TMP=str(tmp), INIT=f"file://{tmp}/pg")
    procs = [subprocess.Popen([sys.executable, "-c", RECOVERY_CODE], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(env, RANK=str(r))) for r in range(4)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for r in range(4):
        with open(tmp / f"rank{r}.json") as f:
            results.append(json.load(f))
    return results, outs[0][0]


def test_every_rank_reports_the_same_run(recovery):
    results, _ = recovery
    for res in results[1:]:
        assert res == results[0]


def test_kill_and_resume_bit_identical(recovery):
    res = recovery[0][0]
    base, f = res["base"], res["kill"]
    assert f["history"] == base["history"][:10]
    (r,) = f["recoveries"]
    assert r["dead"] == [2] and r["mesh_hosts"] == [0, 1]  # 3 survivors -> d = 2
    assert r["reclaimed"] > 0 and r["steps_replayed"] > 0
    assert f["switch"]["stale"] == 0  # the survivors' resubmissions all landed
    assert f["mesh_hosts"] == [0, 1]
    assert {t["mesh"] for t in f["timeline"]} == {4, 2}


def test_revive_grows_back_bit_identical(recovery):
    res = recovery[0][0]
    assert res["revive"]["history"] == res["base"]["history"]
    assert res["revive"]["mesh_hosts"] == [0, 1, 2, 3]
    assert [t["mesh"] for t in res["revive"]["timeline"]][-1] == 4


def test_controller_spans_keep_the_reference_names(recovery):
    names = set(recovery[0][0]["span_names"])
    assert {"controller.step", "controller.recover", "recover.drain_switch",
            "recover.restore", "controller.grow"} <= names


def test_switch_emu_kill_and_resume_bit_identical(recovery):
    res = recovery[0][0]
    assert res["emu_kill"]["history"] == res["emu_base"]["history"]
    assert res["emu_kill"]["recoveries"][0]["reclaimed"] > 0


def test_shard_reassignment_invoked_and_stream_identical(recovery):
    res = recovery[0][0]
    owner, replacement = res["reassign_owner"]
    assert owner == replacement != 3
    assert res["reassign_same_batch"]
    assert res["reassign"]["history"] == res["base"]["history"][:8]


def test_cli_fault_plan_under_torchrun(tmp_path):
    """The launcher's controller path on 4 gloo ranks started by torchrun:
    the recovery line, and the same losses as the uninterrupted run above
    prints."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", "qwen1.5-0.5b",
         "--smoke", "--steps", "6", "--global-batch", "8", "--seq-len", "32",
         "--fault-plan", "kill:2@1", "--num-hosts", "4", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-every", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-4000:]
    assert re.search(r"RECOVERY dead=\[2\] .* mesh=\[0, 1\] reclaimed=[1-9]", res.stdout)
    assert re.search(r"done: 6 steps in .* 1 recoveries", res.stdout)
