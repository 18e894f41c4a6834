"""Cluster health: heartbeats, failure detection, straggler policy (a copy
of the reference's ``repro/runtime/health.py``: pure Python, no framework).

Control-plane logic run identically by every rank: a coordinator
tracks per-host heartbeats and step-completion times; hosts that miss
``timeout`` are declared dead and their data shards reassigned
deterministically (see data/pipeline.reassign_shard — the replacement
regenerates the identical stream). A dead host that heartbeats again is
*revived*: its shard reassignment is retracted so exactly one host generates
each stream. Stragglers are flagged by comparing each host's RECENT
completion-time window against the cross-host median of the same windows —
one GC pause cannot flag a healthy host (the window median absorbs it), and a
slowly-degrading host is judged against its peers, not its own old samples.
The straggler hook is a re-shard recommendation; in a real deployment this
drives the scheduler.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


@dataclasses.dataclass
class HostState:
    last_heartbeat: float
    step_times: deque
    alive: bool = True


class HealthMonitor:
    def __init__(self, hosts: list[int], timeout: float = 60.0,
                 straggler_factor: float = 2.0, window: int = 16,
                 recent: int = 4, min_samples: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        self.recent = recent  # per-host comparison window (last N step times)
        self.min_samples = min_samples  # hosts with fewer samples are exempt
        self.clock = clock
        self.hosts = {
            h: HostState(last_heartbeat=clock(), step_times=deque(maxlen=window))
            for h in hosts
        }
        self.reassignments: dict[int, int] = {}  # dead shard -> replacement host

    def heartbeat(self, host: int, step_time: float | None = None):
        st = self.hosts[host]
        st.last_heartbeat = self.clock()
        if not st.alive:
            # revival: the host is generating its own stream again, so the
            # reassignment MUST be retracted — otherwise two hosts regenerate
            # the same shard (duplicate data in every global batch). Its
            # retained step times are from before the outage — a stale era
            # that would misread as straggling against peers' fresh windows.
            st.alive = True
            st.step_times.clear()
            self.reassignments.pop(host, None)
        if step_time is not None:
            st.step_times.append(step_time)

    def _recent_medians(self, now: float) -> dict[int, float]:
        """Per-host median of the last ``recent`` step times. Guards: alive,
        at least ``min_samples`` samples (tiny-sample guard), and a heartbeat
        within half the death timeout — a silent-but-not-yet-declared host's
        window is frozen in an older era (e.g. still holding warmup-slow
        steps its peers have aged out) and must not be read as straggling;
        it is on the death track, not the straggler track."""
        out = {}
        for h, st in self.hosts.items():
            if (st.alive and len(st.step_times) >= self.min_samples
                    and now - st.last_heartbeat <= self.timeout / 2):
                out[h] = _median(list(st.step_times)[-self.recent:])
        return out

    def check(self) -> dict:
        """Returns {'dead': [...], 'stragglers': [...], 'reassign': {shard: host}}."""
        now = self.clock()
        dead = []
        for h, st in self.hosts.items():
            if st.alive and now - st.last_heartbeat > self.timeout:
                st.alive = False
                dead.append(h)

        # stragglers: each alive host's recent-window median vs the cross-host
        # median of those same windows. Needs >= 2 comparable hosts — with one
        # host there is no peer baseline and nothing is flagged.
        stragglers = []
        recents = self._recent_medians(now)
        if len(recents) >= 2:
            cross = _median(recents.values())
            stragglers = [h for h, m in sorted(recents.items())
                          if m > self.straggler_factor * cross]

        survivors = sorted(h for h, s in self.hosts.items() if s.alive)
        # deterministic reassignment: dead shard -> lowest-id surviving host;
        # NEVER re-reassign a shard that already has a replacement (revival
        # retracts entries, so presence here means the host is still dead)
        reassign = {}
        for i, h in enumerate(sorted(dead)):
            if survivors and h not in self.reassignments:
                reassign[h] = survivors[i % len(survivors)]
        # re-route existing reassignments whose replacement has since died
        for h, repl in sorted(self.reassignments.items()):
            if survivors and not self.hosts[repl].alive:
                reassign[h] = survivors[0]
        self.reassignments.update(reassign)
        return {"dead": dead, "stragglers": stragglers, "reassign": reassign}
