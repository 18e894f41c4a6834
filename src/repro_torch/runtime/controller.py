"""Failure-injecting elastic training controller: survive worker death across
the switch dataplane and the training runtime (torch port of
``repro.runtime.controller``).

The paper's in-network aggregation keeps per-job state (slot pool, worker
bitmaps) INSIDE the switch, so a worker death is not just a scheduler event:
unfilled completion bitmaps park switch slots forever unless the control
plane reclaims them. This controller ties the whole recovery path together:

* **Hosts are ranks.** The job's hosts are ranks 0..num_hosts-1 of the
  default process group (one process of its own without one). Every rank
  runs the same deterministic control loop: the fault plan, the simulated
  clock, the health monitor and the switch mirror are the same on every
  rank, and the step's loss and time are broadcast from the first mesh
  host, so every rank takes every decision the same way and its
  ``history`` is the same. Only the ranks of the current mesh step, in a
  data group of their own (``elastic.make_data_group``); every rank joins
  every group creation, barrier and broadcast of the default group.

* **Logical workers.** The job has W = num_hosts fixed logical workers
  (= switch ports = data shards), decoupled from the mesh. Each mesh rank
  hosts W / mesh_size of them and the gradients aggregate through the
  stacked integer-domain collectives (core/allreduce.py), whose bits are
  identical on ANY mesh dividing W. That invariance makes recovery exact.

* **Heartbeats.** Hosts heartbeat after every step into a ``HealthMonitor``
  driven by the simulated clock (1 tick per step). A fault plan
  (``parse_fault_plan``) silences a host from step k on; the monitor's
  timeout declares it dead a few steps later (``steps_to_detect``). A
  silenced host stays in the mesh, and keeps stepping, until the
  controller declares it dead and regroups without it; its process stays
  up throughout.

* **Switch reclamation.** Every rank mirrors the job's streaming window on
  a persistent emulated dataplane (one port per mesh host, monotone chunk
  ids via ``chunk_base``). On a declared death the in-flight window is
  drained with the failure injected: ``run_aggregation(fail_worker=...)``
  reclaims the dead port's parked slots (``reclaimed``) and the survivors'
  retransmissions complete every chunk. The dataplane is then rebuilt for
  the survivor ports.

* **Data failover.** Shard ownership is re-derived from
  ``HealthMonitor.reassignments`` every step: a dead host's shard loader is
  rebuilt on its replacement (``data/pipeline.reassign_shard``; the
  deterministic stream keeps the global batch identical), and a revival
  retracts it again.

* **Elastic resume.** Checkpoints are atomic params+opt bundles labeled with
  the NEXT step to run, written by the first mesh host, followed by a
  barrier. On recovery the controller discards bundles tainted by the dead
  host (committed after its last heartbeat), restores the newest clean one
  onto the survivor mesh (``elastic.resume_on_mesh``), rebuilds the step
  (which re-plans the bucketed collective for the new k) and replays.
  Replayed losses are checked bit-equal to the recorded ones (on the card
  inside ``elastic.reproducible``, which makes the backward repeat its
  bits).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch import switchsim
from repro_torch import trace as _trace
from repro_torch.core.agg import AggConfig, Aggregator
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus, reassign_shard
from repro_torch.models.registry import build, param_count
from repro_torch.optim import optimizers
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import elastic
from repro_torch.runtime.health import HealthMonitor
from repro_torch.train.step import make_train_step


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    step: int
    kind: str  # "kill" | "revive" | "slow"
    host: int
    factor: float = 1.0  # "slow" only: reported step-time multiplier


def parse_fault_plan(spec: str | None) -> tuple[FaultEvent, ...]:
    """Parse ``kill:<host>@<step>[,revive:<host>@<step>,slow:<host>@<step>x<f>]``.

    Examples: ``kill:2@5``; ``kill:2@5,revive:2@20``; ``slow:3@4x6``.
    ``kill`` silences the host's heartbeats from that step on; ``revive``
    resumes them; ``slow`` multiplies the host's reported step times (a
    degrading host for the straggler detector) until the next event."""
    if not spec:
        return ()
    events = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            kind, rest = part.split(":", 1)
            host_s, at = rest.split("@", 1)
            factor = 1.0
            if "x" in at:
                at, f = at.split("x", 1)
                factor = float(f)
            ev = FaultEvent(step=int(at), kind=kind, host=int(host_s), factor=factor)
        except ValueError as e:
            raise ValueError(f"bad fault-plan entry {part!r} "
                             f"(want kind:host@step[xfactor])") from e
        if ev.kind not in ("kill", "revive", "slow"):
            raise ValueError(f"unknown fault kind {ev.kind!r} in {part!r}")
        events.append(ev)
    return tuple(sorted(events, key=lambda e: e.step))


@dataclasses.dataclass
class RecoveryReport:
    detected_at_step: int      # step after which the death was declared
    dead: list[int]
    last_good_step: int        # newest step known completed by every dead host
    resumed_from: int          # next-step label of the restored checkpoint
    steps_to_detect: int       # kill -> declaration latency (heartbeat timeout)
    steps_replayed: int        # resumed_from .. detected_at_step replay length
    mesh_hosts: list[int]      # survivor hosts backing the new mesh
    reclaimed: int             # switch slots freed by dead-port reclamation
    switch_stats: dict         # dataplane counters at teardown (incl. reclaimed)


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


class ElasticController:
    """Drives the training loop with heartbeats, fault injection, switch-slot
    reclamation and bit-identical elastic resume (module doc). Every rank of
    the default group constructs it with the same arguments and calls
    ``run()``.

    ``run()`` returns a summary dict, the same on every rank:
      ``history``     — [loss of step 0, ..., loss of step steps-1] (final values)
      ``recoveries``  — [RecoveryReport as dict, ...]
      ``stragglers``  — {step: [hosts flagged]}
      ``switch``      — final dataplane counters (incl. ``reclaimed``)
    """

    def __init__(self, cfg, *, steps: int, global_batch: int, seq_len: int,
                 agg: AggConfig, num_hosts: int | None = None,
                 ckpt_dir: str | None = None, ckpt_every: int = 5,
                 fault_plan: tuple[FaultEvent, ...] | str = (),
                 seed: int = 0, heartbeat_timeout: float = 2.5,
                 switch_slots: int = 4, switch_elems: int = 64,
                 fingerprint_elems: int = 512, opt_overrides: dict | None = None,
                 log_every: int = 10, device=None):
        self.cfg = cfg
        self.steps = steps
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.agg = agg
        self.device = resolve_device(device)
        # validate the aggregation config through the facade ONCE, up front:
        # the controller runs the stacked (logical-worker) collectives, so a
        # strategy that cannot stack, or any bad strategy/backend/chunk
        # combination, fails here and not after the first failure
        self.aggregator = Aggregator(agg, stacked=True)
        self.rank = dist.get_rank() if _distributed() else 0
        world = dist.get_world_size() if _distributed() else 1
        self.num_hosts = num_hosts or world
        if self.num_hosts > world:
            raise ValueError(f"num_hosts={self.num_hosts} exceeds the {world} ranks of "
                             f"the default process group")
        if global_batch % self.num_hosts:
            raise ValueError(f"global_batch={global_batch} must divide over "
                             f"num_hosts={self.num_hosts} logical workers")
        self.fault_plan = (parse_fault_plan(fault_plan)
                           if isinstance(fault_plan, str) else tuple(fault_plan))
        for ev in self.fault_plan:
            # an out-of-range kill would silently never fire and a matching
            # revive would KeyError the heartbeat loop mid-run: refuse early
            if not 0 <= ev.host < self.num_hosts:
                raise ValueError(
                    f"fault plan names host {ev.host} but the job has "
                    f"{self.num_hosts} hosts (0..{self.num_hosts - 1})")
        # a directory the controller made itself goes when run() ends
        self._owns_ckpt_dir = ckpt_dir is None
        self.ckpt_dir = self._shared_ckpt_dir(ckpt_dir)
        # a controller run owns its checkpoint namespace from step 0: bundles
        # left by a previous job would otherwise win latest_step on recovery
        # (restoring another run's params) or evict this run's fresh bundles
        # through the keep=N retention
        if self.rank == 0:
            self._reset_ckpt_dir()
        self._barrier()
        self.ckpt_every = max(1, ckpt_every)
        self.seed = seed
        self.switch_slots = switch_slots
        self.switch_elems = switch_elems
        self.fingerprint_elems = fingerprint_elems
        self.log_every = log_every
        self._say = print if self.rank == 0 else (lambda *a, **k: None)

        self.model = build(cfg, device=self.device, seed=seed)
        opt_kw = {"name": cfg.optimizer, "lr": cfg.learning_rate}
        opt_kw.update(opt_overrides or {})
        self.opt_cfg = optimizers.OptConfig(**opt_kw)
        self.opt_state = optimizers.init(list(self.model.parameters()), self.opt_cfg)

        # W logical workers == data shards; host h primarily owns shard h
        w = self.num_hosts
        self.corpus = SyntheticCorpus(cfg.vocab_size, seed)
        self._primary = {
            h: ShardedLoader(self.corpus, global_batch, seq_len, shard_id=h, num_shards=w)
            for h in range(w)
        }
        self._shard_loaders = dict(self._primary)  # shard -> current loader
        self._shard_owner = {s: s for s in range(w)}

        # simulated control-plane clock: 1 tick per training step
        self._now = 0.0
        self.health = HealthMonitor(hosts=list(range(w)), timeout=heartbeat_timeout,
                                    clock=lambda: self._now)
        self._beating = set(range(w))     # hosts currently sending heartbeats
        self._slow = {}                   # host -> step-time multiplier
        self._last_beat_step = {h: -1 for h in range(w)}

        # the initial state on the host, for a fresh start, and the trees
        # restores are shaped like
        self._init_host = ckpt.host_copy(ckpt.state_trees(self.model, self.opt_state))

        self.mesh_hosts: list[int] = []
        self.group = None
        self.switch = None
        self._chunk_base = 0
        self.recoveries: list[RecoveryReport] = []
        self.straggler_log: dict[int, list[int]] = {}
        self._reclaimed_total = 0
        self._remesh(sorted(self._beating), restore=False)

    # -- ranks ---------------------------------------------------------------

    def _shared_ckpt_dir(self, ckpt_dir: str | None) -> str:
        """The checkpoint directory every rank uses: the given one, or a new
        temporary directory made by rank 0 and broadcast (removed by rank 0
        when ``run()`` ends)."""
        if ckpt_dir is None and self.rank == 0:
            ckpt_dir = tempfile.mkdtemp(prefix="fpisa_ctl_")
        if _distributed():
            box = [ckpt_dir]
            dist.broadcast_object_list(box, src=0)
            ckpt_dir = box[0]
        return ckpt_dir

    def _barrier(self):
        if _distributed():
            dist.barrier()

    @property
    def _writer(self) -> int:
        return self.mesh_hosts[0]

    def _save_bundle(self, step: int, extra: dict | None = None):
        """The first mesh host commits the bundle; every rank waits for it."""
        if self.rank == self._writer:
            ckpt.save_bundle(self.ckpt_dir, step,
                             ckpt.state_trees(self.model, self.opt_state), extra)
        self._barrier()

    # -- mesh / switch lifecycle ------------------------------------------

    def _remesh(self, survivors: list[int], restore: bool,
                max_step: int | None = None) -> int:
        """(Re)build the data group and the step on ``survivors``; returns
        the next step to run (0 when starting fresh, the restored label
        otherwise)."""
        w = self.num_hosts
        d = _largest_divisor_leq(w, len(survivors))
        self.mesh_hosts = survivors[:d]
        # every rank creates the group, member or not
        self.group = elastic.make_data_group(self.mesh_hosts)
        self.in_mesh = self.rank in self.mesh_hosts

        next_step = 0
        latest = None
        if restore:
            if max_step is not None:
                if self.rank == self._writer:
                    self._drop_tainted_checkpoints(max_step)
                self._barrier()
            latest = ckpt.latest_step(self.ckpt_dir)
        if latest is None:
            self.opt_state = ckpt.load_state(self.model, self.opt_state, self._init_host)
        else:
            next_step = latest
            if self.in_mesh:  # only the mesh ranks step, so only they restore
                like = ckpt.state_trees(self.model, self.opt_state)
                params, opt, _ = elastic.resume_on_mesh(self.ckpt_dir, like["params"],
                                                        like["opt"], self.device)
                self.opt_state = ckpt.load_state(self.model, self.opt_state,
                                                 {"params": params, "opt": opt})
        # rebuilding the step re-plans the stacked bucketed collective for
        # the new k; the bucket boundaries do not move
        self.step_fn = (make_train_step(self.model, self.agg, self.opt_cfg, self.global_batch,
                                        group=self.group, logical_workers=w)
                        if self.in_mesh else None)

        # fresh switch for the new port set (one port per mesh host)
        self.switch = switchsim.NumpyDataplane(switchsim.DataplaneConfig(
            num_workers=len(self.mesh_hosts), num_slots=self.switch_slots,
            elems_per_packet=self.switch_elems))
        return next_step

    def _reset_ckpt_dir(self):
        if not os.path.isdir(self.ckpt_dir):
            return
        wiped = 0
        for name in os.listdir(self.ckpt_dir):
            if name.startswith("step_"):
                shutil.rmtree(os.path.join(self.ckpt_dir, name), ignore_errors=True)
                wiped += 1
            elif name in ("latest", "latest.tmp"):
                os.remove(os.path.join(self.ckpt_dir, name))
        if wiped:
            print(f"[controller] reset ckpt dir {self.ckpt_dir}: removed "
                  f"{wiped} stale checkpoint(s) from a previous run")

    def _drop_tainted_checkpoints(self, max_step: int):
        """Remove bundles committed after the dead hosts' last heartbeat:
        they were written from state the dead host never contributed to."""
        for s in ckpt.committed_steps(self.ckpt_dir):
            if s > max_step:
                shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"), ignore_errors=True)
        latest = os.path.join(self.ckpt_dir, "latest")
        if os.path.exists(latest):
            os.remove(latest)  # force the directory-scan fallback

    # -- data / switch per-step machinery ---------------------------------

    def _sync_loaders(self):
        """Derive shard -> loader from the monitor's reassignment table (the
        single source of truth, so revivals retract automatically)."""
        for s in range(self.num_hosts):
            owner = self.health.reassignments.get(s, s)
            if owner != self._shard_owner[s]:
                self._shard_loaders[s] = (
                    self._primary[s] if owner == s
                    else reassign_shard(self._primary[owner], new_shard_id=s))
                self._shard_owner[s] = owner

    def _global_tokens(self, step: int) -> np.ndarray:
        parts = [self._shard_loaders[s].batch_at(step)["tokens"]
                 for s in range(self.num_hosts)]
        return np.concatenate(parts, axis=0)

    def _fingerprints(self, step: int) -> np.ndarray:
        """Per-port shadow payloads mirroring the step's streaming window."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0x5717C4, step]))
        return (rng.standard_normal((len(self.mesh_hosts), self.fingerprint_elems))
                * 0.1).astype(np.float32)

    def _switch_step(self, step: int, fail_port: int | None = None) -> dict:
        vecs = self._fingerprints(step)
        switchsim.run_aggregation(
            self.switch, vecs, chunk_base=self._chunk_base,
            fail_worker=fail_port, fail_round=1 if fail_port is not None else None)
        self._chunk_base += -(-self.fingerprint_elems // self.switch_elems)
        return dict(self.switch.stats)

    def _train_step(self, step: int) -> tuple[float, float]:
        """One step on the mesh ranks; (loss, seconds), as measured by the
        first mesh host, on every rank."""
        t0 = time.perf_counter()
        if self.in_mesh:
            d = len(self.mesh_hosts)
            local = self.global_batch // d
            at = self.mesh_hosts.index(self.rank) * local
            tokens = torch.from_numpy(self._global_tokens(step)[at:at + local])
            self.opt_state, metrics = self.step_fn(self.opt_state,
                                                   {"tokens": tokens.to(self.device)})
            loss = metrics["loss"].to(torch.float64)
        else:
            loss = torch.zeros((), dtype=torch.float64, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = torch.stack([loss, torch.tensor(time.perf_counter() - t0, dtype=torch.float64,
                                              device=self.device)])
        if _distributed():
            dist.broadcast(out, src=self._writer)
        loss, dt = out.tolist()
        return float(np.float32(loss)), dt

    # -- main loop ---------------------------------------------------------

    def run(self) -> dict:
        try:
            with elastic.reproducible(self.device):
                out = self._run()
            self._barrier()  # every rank is done with the bundles
        finally:
            if self._owns_ckpt_dir and self.rank == 0:
                shutil.rmtree(self.ckpt_dir, ignore_errors=True)
        return out

    def _run(self) -> dict:
        w = self.num_hosts
        self._say(f"[controller] {self.cfg.name}: {param_count(self.model) / 1e6:.1f}M params, "
                  f"W={w} logical workers, mesh={self.mesh_hosts}, "
                  f"agg={self.agg.strategy}, faults={list(self.fault_plan)}")
        history: dict[int, float] = {}
        timeline: list[dict] = []  # chronological, replays included
        # initial clean bundle so a pre-first-checkpoint death can restore
        self._save_bundle(0)
        step = 0
        wall0 = time.perf_counter()
        while step < self.steps:
            for ev in self.fault_plan:
                if ev.step == step:
                    if ev.kind == "kill":
                        self._beating.discard(ev.host)
                    elif ev.kind == "revive":
                        self._beating.add(ev.host)
                        self._slow.pop(ev.host, None)
                    elif ev.kind == "slow":
                        self._slow[ev.host] = ev.factor

            with _trace.span("controller.step", phase="step", step=step,
                             mesh=len(self.mesh_hosts)):
                loss, dt = self._train_step(step)

            if step in history and history[step] != loss:
                raise AssertionError(
                    f"replayed step {step} diverged: {history[step]} != {loss} "
                    f"(bit-identical elastic resume violated)")
            history[step] = loss
            timeline.append({"step": step, "loss": loss, "dt": dt,
                             "mesh": len(self.mesh_hosts)})
            self._switch_step(step)

            # heartbeats + failure detection on the simulated clock
            self._now += 1.0
            for h in sorted(self._beating):
                self.health.heartbeat(h, dt * self._slow.get(h, 1.0))
                self._last_beat_step[h] = step
            res = self.health.check()
            if res["stragglers"]:
                self.straggler_log[step] = res["stragglers"]
            self._sync_loaders()

            if step % self.log_every == 0 or step == self.steps - 1:
                tok_s = self.global_batch * self.seq_len / max(dt, 1e-9)
                self._say(f"[controller] step {step:5d} loss {loss:.4f} "
                          f"{tok_s:,.0f} tok/s mesh={len(self.mesh_hosts)}")

            if res["dead"]:
                step = self._recover(res["dead"], step)
                continue

            # revived host available again and capacity to grow? re-mesh up.
            alive = sorted(h for h, s in self.health.hosts.items() if s.alive)
            if _largest_divisor_leq(w, len(alive)) > len(self.mesh_hosts):
                step = self._grow(alive, step)
                continue

            step += 1
            if step % self.ckpt_every == 0 or step == self.steps:
                self._save_bundle(step, {"loss": loss})
        self._say(f"[controller] done: {self.steps} steps in "
                  f"{time.perf_counter() - wall0:.1f}s, {len(self.recoveries)} recoveries, "
                  f"{self._reclaimed_total} switch slots reclaimed")
        return {
            "history": [history[s] for s in range(self.steps)],
            "timeline": timeline,
            "recoveries": [dataclasses.asdict(r) for r in self.recoveries],
            "stragglers": self.straggler_log,
            "switch": dict(self.switch.stats),
            "mesh_hosts": list(self.mesh_hosts),
        }

    # -- recovery ----------------------------------------------------------

    def _recover(self, dead: list[int], step: int) -> int:
        """Full recovery path after declared deaths; returns the next step."""
        with _trace.span("controller.recover", phase="recover", step=step, dead=list(dead)):
            # 1. switch side: drain the in-flight window with the failure
            #    live; the dead ports' slots are reclaimed and the survivors
            #    resubmit from shadow copies; completing proves no slot stays
            #    parked
            with _trace.span("recover.drain_switch", phase="recover"):
                stats = dict(self.switch.stats)
                for h in dead:
                    if h in self.mesh_hosts:
                        stats = self._switch_step(step, fail_port=self.mesh_hosts.index(h))
            reclaimed = stats["reclaimed"]
            self._reclaimed_total += reclaimed

            # 2. the dead hosts' contributions stop at their last heartbeat:
            #    anything newer (checkpoints included) is tainted
            last_good = min(self._last_beat_step[h] for h in dead)
            survivors = sorted(h for h, s in self.health.hosts.items() if s.alive)
            if not survivors:
                raise RuntimeError("all hosts dead; nothing to recover onto")

            # 3. regroup the survivors and restore the newest clean bundle
            with _trace.span("recover.restore", phase="recover"):
                resumed_from = self._remesh(survivors, restore=True, max_step=last_good + 1)
        report = RecoveryReport(
            detected_at_step=step, dead=list(dead), last_good_step=last_good,
            resumed_from=resumed_from, steps_to_detect=step - last_good,
            steps_replayed=max(0, step + 1 - resumed_from),
            mesh_hosts=list(self.mesh_hosts), reclaimed=reclaimed, switch_stats=stats)
        self.recoveries.append(report)
        self._say(f"[controller] RECOVERY dead={dead} detected@{step} "
                  f"last_good={last_good} resume@{resumed_from} "
                  f"mesh={self.mesh_hosts} reclaimed={reclaimed}")
        return resumed_from

    def _grow(self, alive: list[int], step: int) -> int:
        """Scale back up onto revived hosts: checkpoint the current state,
        then regroup and restore (no replay: the state is clean)."""
        with _trace.span("controller.grow", phase="recover", step=step):
            self._save_bundle(step + 1)
            resumed_from = self._remesh(alive, restore=True)
        self._say(f"[controller] GROW mesh={self.mesh_hosts} resume@{resumed_from}")
        return resumed_from


def run_controller(cfg, *, steps, global_batch, seq_len, agg: AggConfig | None = None,
                   num_hosts=None, ckpt_dir=None, ckpt_every=5, fault_plan="",
                   log_every=10, device=None) -> dict:
    """Build an ``ElasticController`` and run it (the launcher's
    ``--fault-plan`` / ``--num-hosts`` path). Construction checks raise
    ``ValueError`` before any step runs."""
    ctl = ElasticController(
        cfg, steps=steps, global_batch=global_batch, seq_len=seq_len, agg=agg or AggConfig(),
        num_hosts=num_hosts, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        fault_plan=fault_plan, log_every=log_every, device=device)
    return ctl.run()
