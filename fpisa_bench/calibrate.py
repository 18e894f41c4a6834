"""Readings that the limits of a cell's comparison are set from, on the
card at the cell's own size (not run by the benchmark's runs):

    python3 -m fpisa_bench.calibrate --workload <name> --seeds 1,2,... \
        [--control N] [--faults N] [--seconds S] [--out FILE]

For every seed, the program's sound run (its set-up, a window of
``--seconds`` and the comparison). For the first ``--control`` seeds, the
control: for a training cell, the plain reference put in the program's
place and computed with every matrix product in fp8 (e4m3 operands, e5m2
gradients, one scale a tensor), the precision below the configuration's
bf16; for an aggregation cell, the program's own FPISA path in the bf16
format, the format below the configuration's fp32. For the first
``--faults`` seeds of a training cell, the program with half of each batch
left out (the mean loss over the other half). One JSON line each, then the
largest sound reading and the smallest control and fault reading of every
number compared.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

from fpisa_bench import run as bench_run

FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}


def fp8_matmul():
    """``mm(a, b)`` with both operands rounded to float8 e4m3 and the
    incoming gradient to e5m2, each with one scale a tensor (its largest
    magnitude to the format's largest), accumulated in float32."""
    import torch

    def q(x, fmt):
        dtype = torch.float8_e4m3fn if fmt == "e4m3" else torch.float8_e5m2
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX[fmt] / amax
        return (x * scale).to(dtype).to(torch.float32) / scale

    class Fp8Matmul(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            a8, b8 = q(a, "e4m3"), q(b, "e4m3")
            ctx.save_for_backward(a8, b8)
            return a8 @ b8

        @staticmethod
        def backward(ctx, g):
            a8, b8 = ctx.saved_tensors
            g8 = q(g, "e5m2")
            ga = g8 @ b8.transpose(-1, -2)
            if b8.dim() == 2:
                gb = a8.reshape(-1, a8.shape[-1]).T @ g8.reshape(-1, g8.shape[-1])
            else:
                gb = a8.transpose(-1, -2) @ g8
            return ga, gb

    return Fp8Matmul.apply


@contextlib.contextmanager
def half_batch():
    """The program's loss over the first half of each batch's rows."""
    from repro_torch.models.transformer import TransformerLM

    plain = TransformerLM.loss
    TransformerLM.loss = lambda self, batch: plain(
        self, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    try:
        yield
    finally:
        TransformerLM.loss = plain


def one_run(cell, seed: int, seconds: float):
    import torch

    from fpisa_bench import common, spec

    r = common.Run(cell, seed, seconds, False, torch.device("cuda", 0))
    spec.kind(cell.traffic["kind"]).run(r, cell.limits())
    torch.cuda.empty_cache()
    return r


def control_train(cell, seed: int, reference: dict) -> dict:
    import torch

    from fpisa_bench import common, reference_train, spec
    from fpisa_bench.kinds import train

    dev = torch.device("cuda", 0)
    cfg, tr = cell.config, cell.traffic
    model = spec.reference(cell.config_name)
    pdtype = getattr(torch, cfg["program"]["param_dtype"])
    got = reference_train.follow(
        model, cfg, common.make_weights(model.param_spec(cfg), seed, dev, pdtype),
        list(train.batches(cfg, tr, seed, tr["check_steps"], dev)), tr["optimizer"], pdtype,
        mm=fp8_matmul())
    torch.cuda.empty_cache()
    return train.compare(got, reference)


def readings(cell, seeds: list, control: int, faults: int, seconds: float):
    """Yields {"seed", "run", "checks"} for every run (module doc)."""
    for i, seed in enumerate(seeds):
        r = one_run(cell, seed, seconds)
        yield {"seed": seed, "run": "program", "checks": {k: v for k, (v, _) in r.checks.items()},
               "window": [r.window.count, r.window.seconds]}
        kind = cell.traffic["kind"]
        if i < control and kind == "train":
            yield {"seed": seed, "run": "control_fp8",
                   "checks": control_train(cell, seed, r.readings["reference"])}
        elif i < control:
            plain = cell.traffic
            cell.traffic = dict(plain, agg=dict(plain["agg"], fmt_name="bf16"))
            try:
                c = one_run(cell, seed, seconds)
            finally:
                cell.traffic = plain
            yield {"seed": seed, "run": "control_bf16_format",
                   "checks": {k: v for k, (v, _) in c.checks.items()}}
        if i < faults and kind == "train":
            with half_batch():
                f = one_run(cell, seed, seconds)
            yield {"seed": seed, "run": "half_batch",
                   "checks": {k: v for k, (v, _) in f.checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench_run.prepare()
    from fpisa_bench import spec

    cell = spec.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    summary: dict = {}
    out = open(args.out, "a") if args.out else None
    try:
        for line in readings(cell, seeds, args.control, args.faults, args.seconds):
            line["workload"] = cell.name
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                print(text, file=out, flush=True)
            for k, v in line["checks"].items():
                pick = max if line["run"] == "program" else min
                key = (line["run"], k)
                summary[key] = pick(summary.get(key, v), v)
    finally:
        if out:
            out.close()
    for (run, k), v in sorted(summary.items()):
        print(f"[calibrate] {cell.name} {run} {k} {'largest' if run == 'program' else 'smallest'} "
              f"{v!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
