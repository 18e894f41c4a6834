"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m fpisa_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up, a window of ``--seconds`` on the host clock, then (``--trace 1``)
the profiled sub-windows, then the comparison with the plain reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which are also the last lines of standard error. Exits non-zero, with no
result, without enough CUDA cards, without the program (``src/
repro_torch``), or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "fpisa_bench"
CACHE_VARS = {"CUDA_CACHE_PATH": "cuda", "TRITON_CACHE_DIR": "triton",
              "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
              "TORCH_EXTENSIONS_DIR": "torch_extensions"}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare() -> None:
    """Point every kernel cache at a fixed folder of the checkout (before
    CUDA starts) and put the program (``src/``) on the import path."""
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT / "src"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _number(v):
    """A JSON number; a non-finite one as its name, so the line parses."""
    v = float(v)
    return v if math.isfinite(v) else str(v)


def result_line(r, cell, metrics: dict) -> dict:
    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(r.memory_peak_bytes)}
    line = {"correct": r.correct and r.failed == 0, "attempted": r.attempted,
            "failed": r.failed, "metrics": metrics, "device": device}
    if r.trace and r.profile is not None:
        device["busy_s"] = r.profile.busy_s
        device["window_s"] = r.profile.window_s
        line["breakdown"] = {"device_ops": r.profile.top_ops(10),
                             "idle_gaps": r.host_profile.idle_gaps if r.host_profile else []}
    line["checks"] = {k: {"value": _number(v), "limit": lim} for k, (v, lim) in r.checks.items()}
    return line


def read_metrics(r, entries: list) -> dict:
    from fpisa_bench import spec

    out = {}
    for m in entries:
        value = spec.metric_reader(m["name"]).read(r)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    prepare()
    import torch

    from fpisa_bench import common, spec

    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 2
    r = common.Run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    spec.kind(cell.traffic["kind"]).run(r, cell.limits())
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (the benchmark runs the PyTorch "
              "port alone)", file=sys.stderr)
        return 3
    line = result_line(r, cell, read_metrics(r, cell.per_layer if r.trace else cell.end_to_end))
    print("set-up: " + ", ".join(f"{phase} to {t:.2f} s" for phase, t in r.marks), file=sys.stderr)
    print(f"reference {r.readings.get('reference_s', 0.0):.1f} s after the window",
          file=sys.stderr)
    for name, (value, limit) in r.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
