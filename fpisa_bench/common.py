"""What every kind of cell shares: the weights made from the seed, the
timed window, the profiler's reading of a sub-window, and the state of one
run (:class:`Run`) that the kinds fill and the metric readers read."""
from __future__ import annotations

import bisect
import json
import math
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time against
    the boot clock, 10 ms resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_weights(spec: list, seed: int, device: torch.device, dtype: torch.dtype) -> dict:
    """{leaf name: tensor} drawn from ``seed`` on ``device`` in ``dtype``:
    the normal leaves of each standard deviation in one call of a seeded
    generator, the rest ones or zeros. The same seed gives the same
    weights."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    by_std = defaultdict(list)
    for name, shape, init in spec:
        if init[0] == "normal":
            by_std[init[1]].append((name, shape))
        else:
            fill = torch.ones if init[0] == "ones" else torch.zeros
            out[name] = fill(shape, dtype=dtype, device=device)
    for std, leaves in sorted(by_std.items()):
        sizes = [math.prod(shape) for _, shape in leaves]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device).normal_(0.0, std, generator=gen)
        for (name, shape), part in zip(leaves, flat.split(sizes)):
            out[name] = part.view(shape).clone()
        del flat
    return {name: out[name] for name, _, _ in spec}


def nest(flat: dict) -> dict:
    """{"a.b.c": t} -> {"a": {"b": {"c": t}}}."""
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


@dataclass
class Window:
    """The measured window: how many steps or calls, the work they did in
    the cell's unit, and the seconds from its start to the synchronize
    after its last one."""
    count: int = 0
    units: float = 0.0
    seconds: float = 0.0


def timed_window(step, seconds: float, device: torch.device, units_per_step: float) -> Window:
    """Call ``step(i)`` back to back until ``seconds`` have passed on the
    host clock, then wait for the device: every step issued is in the
    window and in its time."""
    sync(device)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        step(n)
        n += 1
    sync(device)
    return Window(n, n * units_per_step, time.perf_counter() - t0)


@dataclass
class Profile:
    """Device activity of a profiled sub-window: its ``units`` steps or
    calls, ``kernels`` [(name, start us, duration us)], ``busy_s`` (the
    union of every device operation), ``window_s`` (the sub-window on the
    host clock, from a synchronize to a synchronize), and ``idle_gaps``
    [(host operation, seconds)] when the host side was recorded."""
    units: int
    kernels: list
    busy_s: float
    window_s: float
    idle_gaps: list = field(default_factory=list)

    def time_s(self, match) -> float:
        return sum(d for n, _, d in self.kernels if match(n)) * 1e-6

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.kernels if match(n))

    def top_ops(self, n: int = 10) -> list:
        total = defaultdict(float)
        for name, _, dur in self.kernels:
            total[short_name(name)] += dur * 1e-6
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]


def short_name(name: str) -> str:
    """A kernel's name without its parameter list, its leading ``void`` and
    any ``(anonymous namespace)::``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name if len(name) <= 120 else name[:117] + "..."


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(run_units, units: int, device: torch.device, host: str = "") -> Profile:
    """Run ``run_units()`` (``units`` steps or calls) under torch.profiler
    between two synchronizes. ``host``: record the host's operators too,
    under that label, and name each idle gap of the device by the innermost
    host operator that launched the work ending it (the label where no
    operator of torch's did)."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with torch_profile(activities=acts) as prof:
        sync(device)
        t0 = time.perf_counter()
        if host:
            with record_function(host):
                run_units()
        else:
            run_units()
        sync(device)
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e),
                 key=lambda e: e["ts"])
    kernels = [(e["name"], float(e["ts"]), float(e["dur"])) for e in dev if e["cat"] == "kernel"]
    busy, gaps = _busy_and_gaps(dev)
    out = Profile(units, kernels, busy * 1e-6, window)
    if host:
        out.idle_gaps = _name_gaps(events, gaps, host)
    return out


def _busy_and_gaps(dev: list):
    """(union of the device intervals in us, [(gap us, first event after
    it)])."""
    busy, gaps, end = 0.0, [], None
    for e in dev:
        s, f = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, e))
            busy += f - s
            end = f
        elif f > end:
            busy += f - end
            end = f
    return busy, gaps


def _name_gaps(events: list, gaps: list, label: str, n: int = 10) -> list:
    """[(host operator, idle seconds)], summed by operator, largest first;
    ``label`` where no operator encloses the launch."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ops = sorted((e for e in events if e.get("cat") in ("cpu_op", "user_annotation")
                  and "dur" in e), key=lambda e: e["ts"])
    starts = [float(e["ts"]) for e in ops]
    total = defaultdict(float)
    for length, after in gaps:
        launch = launches.get(after.get("args", {}).get("correlation"))
        name = "no host launch recorded"
        if launch is not None:
            ts, tid = float(launch["ts"]), launch.get("tid")
            i = bisect.bisect_right(starts, ts)
            name = label
            for e in reversed(ops[max(0, i - 400):i]):
                if e.get("tid") == tid and float(e["ts"]) + float(e["dur"]) >= ts:
                    name = e["name"]
                    break
        total[name] += length * 1e-6
    return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]


@dataclass
class Run:
    """One run of one cell. Its kind (``kinds/<kind>.py``) fills the
    window, the traced phases and the comparison; the metric readers read
    them."""
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    setup_s: float = 0.0
    window: Window = field(default_factory=Window)
    window_peak_bytes: int = 0
    memory_peak_bytes: int = 0
    profile: Profile | None = None
    host_profile: Profile | None = None
    spans: list = field(default_factory=list)
    issue_s: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    readings: dict = field(default_factory=dict)
    marks: list = field(default_factory=list)  # (set-up phase, seconds since the start)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in self.checks.values())

    def mark(self, phase: str) -> None:
        """A phase of set-up ends (for the log; ``setup_s`` is the sum)."""
        sync(self.device)
        self.marks.append((phase, process_age_s()))

    def mark_setup_done(self) -> None:
        """Set-up ends here: every shape has run; the window starts."""
        self.mark("warm-up")
        self.setup_s = self.marks[-1][1]
        if self.device.type == "cuda":
            self.memory_peak_bytes = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def mark_window_done(self) -> None:
        if self.device.type == "cuda":
            self.window_peak_bytes = torch.cuda.max_memory_allocated(self.device)
            self.memory_peak_bytes = max(self.memory_peak_bytes, self.window_peak_bytes)

    def mark_traced_done(self) -> None:
        """The program's peak, read before its state is freed and the
        reference runs."""
        if self.device.type == "cuda":
            self.memory_peak_bytes = max(self.memory_peak_bytes,
                                         torch.cuda.max_memory_allocated(self.device))
