#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints on its own lines; any failure raises, exit code != 0):

1. Card facts: the device name, ``nvidia-smi``'s name and power limit, and
   the TF32 switches (both set off: float32 products stay float32).
2. Build: compile every kernel of the port from ``src/repro_torch/csrc``.
3. Kernel parity on the card: K1 (``fpisa_encode_align``) and K2
   (``fpisa_decode_fused``) against their plain PyTorch versions on the
   same CUDA tensors, over the CPU suite's sweep plus +-0, denormals,
   +-inf, NaN and the wire dtypes' extreme values, and at the main path's
   largest leaf; then a 4-worker aggregation on one card (K1 on 4 gradient
   tensors, MAX of block exponents, residual shift and wire cast, integer
   sum, K2) per wire width. Tolerance: none, outputs are compared as
   integers (bit patterns), and ``max_abs_err`` is the largest absolute
   difference of those integers.
4. Training (the main path): qwen1.5-0.5b at full width (24 layers,
   d_model 1024, vocab 151936; bf16 weights from a seed), 3 steps of global
   batch 8 x seq 512 through ``train_loop`` with FPISA aggregation on the
   ``auto`` backend, inside an NCCL process group of one rank so the
   collectives really run. The kernels' launch counts are zeroed just
   before and read just after: each must have launched once per gradient
   leaf per step. Then, on the trained model's gradients, the cuda and the
   plain aggregation must give the same bits, and the loss of the smoke
   config must agree between the two backends.
   A breakdown of one step by layer (forward+backward, aggregation,
   optimizer) follows, on CUDA events.
5. Timing at the main path's shapes (the 14 gradient leaves of one step,
   1,812,452 rows of 256, and the largest leaf alone): CUDA events, median
   of 25 timed runs after warm-up, for each kernel, its plain version, and
   a ``dst.copy_(src)`` of the same bytes (the bandwidth this card reaches).
   The bound is the larger of the bytes over 3.35 TB/s and the integer
   operations over 33.5 TOP/s (H100 SXM data sheet; 64 INT32 lanes per SM,
   half the FP32 rate). No single PyTorch call computes FPISA encode or
   decode, so ``library_ms`` is null.

The line before the last is ``{"kernels": [...]}`` with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repository beside it, the script exits
with code 2 and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
INT32_OPS_PER_S = 33.5e12     # 132 SMs x 64 INT32 lanes x 2 x ~1.98 GHz boost
# integer operations per element, counted from csrc/fpisa_fused.cuh
OPS_PER_ELEM = {"fused_encode_align": 16, "fused_decode": 34}
SWEEP = [(1, 256), (8, 128), (256, 256), (300, 512), (513, 128), (64, 512)]
EMBED_ROWS = 607744           # the embedding gradient: 151936 x 1024 / 256
FMTS = ("fp32", "fp16", "bf16")
STEPS, GLOBAL_BATCH, SEQ_LEN = 3, 8, 512


def log(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase helpers
# ---------------------------------------------------------------------------


def card_facts(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] torch.cuda.get_device_name: {name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device_count {torch.cuda.device_count()}")
    log(smi[0])
    log(f"[card] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return name


def build_kernels():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} librar{'y' if len(libs) == 1 else 'ies'} in "
        f"{time.perf_counter() - t0:.1f} s: " + ", ".join(p.name for p in libs.values()))
    for lib in libs.values():
        report = lib.with_name(lib.name + ".log")
        if report.is_file():  # nvcc -Xptxas -v of this build
            text = report.read_text()
            regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
            spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", text))
            log(f"[build] ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers "
                f"per thread, {spills} bytes of spill stores")


class Parity:
    """Kernel-vs-plain comparisons; records the largest integer difference."""

    def __init__(self, torch):
        self.torch = torch
        self.err = {"fused_encode_align": 0, "fused_decode": 0}
        self.cases = {"fused_encode_align": 0, "fused_decode": 0}

    def check(self, kernel, got, want, what):
        torch = self.torch
        int_view = {4: torch.int32, 2: torch.int16, 1: torch.int8}
        g = got.view(int_view[got.element_size()]).to(torch.int64)
        w = want.view(int_view[want.element_size()]).to(torch.int64)
        if g.shape != w.shape or got.dtype != want.dtype:
            raise AssertionError(f"{kernel} {what}: {got.dtype}{tuple(got.shape)} vs "
                                 f"{want.dtype}{tuple(want.shape)}")
        err = int((g - w).abs().max()) if g.numel() else 0
        self.err[kernel] = max(self.err[kernel], err)
        self.cases[kernel] += 1
        if err:
            raise AssertionError(f"{kernel} differs from its plain version at {what}: "
                                 f"{int((g != w).sum())} elements, max |diff| {err}")


def sample(torch, shape, fmt, seed, dev):
    """Gradient-like values with spread exponents and the special values."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev)
    x *= torch.exp2(torch.randint(-12, 12, shape, generator=gen, device=dev).float())
    specials = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1e-39, -1e-39, 3e-8],
                            device=dev)
    n = min(8, x.numel())
    x.view(-1)[:n] = specials[:n]
    from repro_torch.core.fpisa import PACKED_DTYPE

    return x.to(PACKED_DTYPE[fmt])


def wire_sample(torch, shape, wire, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    info = torch.iinfo(wire)
    m = torch.randint(info.min, info.max, shape, generator=gen, device=dev,
                      dtype=torch.int64).to(wire)
    edges = torch.tensor([info.min, -1, 0, info.max], dtype=wire, device=dev)
    n = min(4, m.numel())
    m.view(-1)[:n] = edges[:n]
    return m


def kernel_parity(torch, dev):
    from repro_torch.core import fpisa
    from repro_torch.core import numerics as nx
    from repro_torch.core.allreduce import _wire_shift
    from repro_torch.kernels import ops, ref

    par = Parity(torch)
    for shape in SWEEP:
        for fmt in FMTS:
            f = fpisa.FORMATS[fmt]
            x = sample(torch, shape, fmt, shape[0] + shape[1], dev)
            man, bmax = ops.encode_align(x, fmt)
            man_r, bmax_r = ref.fused_encode_align_ref(x, f)
            par.check("fused_encode_align", man, man_r, f"{fmt} {shape} man")
            par.check("fused_encode_align", bmax, bmax_r, f"{fmt} {shape} bmax")
            for wire in (torch.int8, torch.int16, torch.int32):
                for preshift in (0, 2):
                    m = wire_sample(torch, shape, wire, shape[0] + preshift, dev)
                    gen = torch.Generator(device=dev).manual_seed(shape[1] + preshift)
                    be = torch.randint(0, f.exp_mask + 2, (shape[0],), generator=gen,
                                       device=dev, dtype=torch.int32)
                    par.check("fused_decode", ops.decode_fused(m, be, preshift, fmt),
                              ref.fused_decode_ref(m, be, preshift, f),
                              f"{fmt} {shape} {wire} preshift {preshift}")
    # the main path's largest leaf: the embedding gradient, 607,744 x 256 fp32
    x = sample(torch, (EMBED_ROWS, 256), "fp32", 1, dev)
    man, bmax = ops.encode_align(x, "fp32")
    man_r, bmax_r = ref.fused_encode_align_ref(x, fpisa.FP32)
    par.check("fused_encode_align", man, man_r, "embedding leaf man")
    par.check("fused_encode_align", bmax, bmax_r, "embedding leaf bmax")
    par.check("fused_decode", ops.decode_fused(man, bmax, 0, "fp32"),
              ref.fused_decode_ref(man, bmax, 0, fpisa.FP32), "embedding leaf")
    del x, man, bmax, man_r, bmax_r
    # a 4-worker aggregation on one card, per wire width
    xs = [torch.nan_to_num(sample(torch, (1024, 256), "fp32", 40 + i, dev),
                           posinf=3.0, neginf=-3.0) for i in range(4)]
    for bits, wdt in ((32, torch.int32), (16, torch.int16), (8, torch.int8)):
        shift = _wire_shift(fpisa.FP32, 4, bits)

        def compose(encode, decode):
            planes = [encode(x) for x in xs]
            bmax = torch.stack([b for _, b in planes]).amax(0)
            total = sum(nx.arshift(m, (bmax - b)[:, None] + shift).to(wdt).to(torch.int32)
                        for m, b in planes)
            return decode(total.to(wdt), bmax)

        got = compose(lambda x: ops.encode_align(x, "fp32"),
                      lambda m, b: ops.decode_fused(m, b, shift, "fp32"))
        want = compose(lambda x: ref.fused_encode_align_ref(x, fpisa.FP32),
                       lambda m, b: ref.fused_decode_ref(m, b, shift, fpisa.FP32))
        par.check("fused_decode", got, want, f"4-worker composition, {bits}-bit wire")
        if not torch.isfinite(got).all():
            raise AssertionError("4-worker aggregate is not finite")
    torch.cuda.synchronize()
    log(f"[parity] bit-equal to the plain versions: fused_encode_align "
        f"{par.cases['fused_encode_align']} cases, fused_decode "
        f"{par.cases['fused_decode']} cases (sweep {SWEEP} x {FMTS}, wires i8/i16/i32, "
        f"preshift 0/2, the embedding leaf, 4-worker composition at wire 32/16/8)")
    return par.err


def train_main_path(torch, dev):
    """The main path, with the launch counts zeroed just before and read
    just after. Returns the launch counts, the losses and the model."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop

    cfg = get_config("qwen1.5-0.5b")
    ops.encode_align.launches = 0
    ops.decode_fused.launches = 0
    t0 = time.perf_counter()
    model, opt_state, losses = train_loop(
        cfg, steps=STEPS, global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN,
        agg=AggConfig(strategy="fpisa", backend="auto"), device=dev, log_every=1)
    torch.cuda.synchronize()
    launches = {"fused_encode_align": ops.encode_align.launches,
                "fused_decode": ops.decode_fused.launches}
    wall = time.perf_counter() - t0
    leaves = len(list(model.parameters()))
    log(f"[train] {STEPS} steps of {cfg.name} in {wall:.2f} s (init included), "
        f"world {dist.get_world_size()} ({dist.get_backend()}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(json.dumps({"launches_per_step": {k: v / STEPS for k, v in launches.items()},
                    "gradient_leaves": leaves}))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for k, v in launches.items():
        if v != leaves * STEPS:
            raise AssertionError(f"{k} launched {v} times in {STEPS} steps, expected "
                                 f"{leaves} per step (one per gradient leaf)")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError("non-finite parameter after training")
    return launches, model, opt_state


def step_breakdown(torch, dev, model, opt_state):
    """Where a full-width training step's time goes, by layer: forward +
    backward, the FPISA aggregation of the 14 gradient leaves (K1, K2 and
    the plain-torch glue between them), and the AdamW update; CUDA events,
    median of 5 runs each after one warm-up, on the same tokens."""
    from repro_torch.core.agg import AggConfig, Aggregator
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
    from repro_torch.optim import optimizers

    cfg = model.cfg
    tokens = torch.from_numpy(ShardedLoader(SyntheticCorpus(cfg.vocab_size, 0), GLOBAL_BATCH,
                                            SEQ_LEN).batch_at(STEPS)["tokens"]).to(dev)
    params = list(model.parameters())
    opt_cfg = optimizers.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
    aggregator = Aggregator(AggConfig(strategy="fpisa"))
    held = {}

    def grads():
        held["g"] = torch.autograd.grad(model.loss(tokens), params)

    def aggregate():
        held["a"] = aggregator.allreduce_tree(list(held["g"]))

    def update():
        optimizers.update(params, held["a"], opt_state, opt_cfg)

    parts = {name: median_ms(torch, fn, reps=5, warmup=1)
             for name, fn in (("forward+backward", grads), ("aggregation", aggregate),
                              ("optimizer", update))}
    total = sum(parts.values())
    log("[breakdown] one step, " + ", ".join(
        f"{k} {v:.2f} ms ({100 * v / total:.1f}%)" for k, v in parts.items())
        + f"; sum {total:.2f} ms = {GLOBAL_BATCH * SEQ_LEN / total * 1e3:,.0f} tok/s")
    return parts


def check_against_plain(torch, dev, model):
    """Right answers by the repo's own means: on the trained full-width
    model's gradients, the cuda aggregation equals the plain one bit for
    bit; on the smoke config, training through the kernels and through the
    plain versions gives the same losses."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.agg import AggConfig, Aggregator
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
    from repro_torch.launch.train import train_loop

    tokens = ShardedLoader(SyntheticCorpus(model.cfg.vocab_size, 0), GLOBAL_BATCH,
                           SEQ_LEN).batch_at(STEPS)["tokens"]
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(model.loss(torch.from_numpy(tokens).to(dev)), params)
    kern, plain = (Aggregator(AggConfig(backend=b)) for b in ("cuda", "torch"))
    for name, g in zip(names, grads):
        a, b = kern.allreduce(g), plain.allreduce(g)
        if not (torch.equal(a.view(torch.int16), b.view(torch.int16))
                and torch.isfinite(a).all()):
            raise AssertionError(f"aggregated gradient {name}: cuda != torch backend")
    del grads
    log(f"[check] full-width gradients ({len(names)} leaves, bf16): cuda aggregation "
        f"bit-equal to the plain aggregation, all finite")
    smoke = get_smoke_config("qwen1.5-0.5b")
    runs = {b: train_loop(smoke, steps=STEPS, global_batch=4, seq_len=64, device=dev,
                          agg=AggConfig(backend=b), log_every=STEPS)[2]
            for b in ("cuda", "torch")}
    if max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"], runs["torch"])) > 1e-6:
        raise AssertionError(f"smoke losses differ between backends: {runs}")
    log(f"[check] smoke losses, cuda vs plain aggregation (rtol 1e-6): {runs}")


def median_ms(torch, fn, reps=25, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timing(torch, dev, leaf_sizes):
    """Per-step times of each kernel, its plain version and a copy of the
    same bytes, over the main path's leaf shapes; then the largest leaf."""
    from repro_torch.core import fpisa
    from repro_torch.kernels import ops, ref

    rows = [-(-n // 256) for n in leaf_sizes]
    xs = [sample(torch, (r, 256), "fp32", i, dev) for i, r in enumerate(rows)]
    xs = [torch.nan_to_num(x, posinf=1.0, neginf=-1.0) for x in xs]
    planes = [ops.encode_align(x, "fp32") for x in xs]
    dsts = [torch.empty_like(x) for x in xs]
    fmt = fpisa.FP32
    total_rows = sum(rows)
    elems = total_rows * 256
    bytes_ = {"fused_encode_align": elems * 8 + total_rows * 4,
              "fused_decode": elems * 8 + total_rows * 4}
    sets = {
        "fused_encode_align": (lambda: [ops.encode_align(x, "fp32") for x in xs],
                               lambda: [ref.fused_encode_align_ref(x, fmt) for x in xs]),
        "fused_decode": (lambda: [ops.decode_fused(m, b, 0, "fp32") for m, b in planes],
                         lambda: [ref.fused_decode_ref(m, b, 0, fmt) for m, b in planes]),
    }
    copy_ms = median_ms(torch, lambda: [d.copy_(x) for d, x in zip(dsts, xs)])
    out = {}
    for name, (kernel, plain) in sets.items():
        k1 = median_ms(torch, kernel)
        p = median_ms(torch, plain, reps=20)
        k2 = median_ms(torch, kernel)  # kernel, plain, kernel: drift shows
        bytes_ms = bytes_[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = elems * OPS_PER_ELEM[name] / INT32_OPS_PER_S * 1e3
        out[name] = {"ms": min(k1, k2), "ms_runs": [k1, k2], "plain_ms": p,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "bytes_ms": bytes_ms, "ops_ms": ops_ms, "copy_ms": copy_ms}
        log(f"[time] {name}: one step = {len(xs)} leaves, {total_rows} rows x 256 fp32: "
            f"kernel {k1:.4f} / {k2:.4f} ms, plain {p:.3f} ms, bound {max(bytes_ms, ops_ms):.4f} "
            f"ms (bytes {bytes_ms:.4f}, int32 ops {ops_ms:.4f}), copy_ of the same bytes "
            f"{copy_ms:.4f} ms; {bytes_[name] / (min(k1, k2) * 1e-3) / 1e12:.3f} TB/s")
    # the largest leaf alone (the embedding, 607,744 rows)
    big = max(range(len(xs)), key=lambda i: rows[i])
    x, (m, b), d = xs[big], planes[big], dsts[big]
    for name, fn, pfn in (
            ("fused_encode_align", lambda: ops.encode_align(x, "fp32"),
             lambda: ref.fused_encode_align_ref(x, fmt)),
            ("fused_decode", lambda: ops.decode_fused(m, b, 0, "fp32"),
             lambda: ref.fused_decode_ref(m, b, 0, fmt))):
        log(f"[time] {name}: largest leaf {rows[big]} x 256: kernel "
            f"{median_ms(torch, fn):.4f} ms, plain {median_ms(torch, pfn, reps=20):.3f} ms, "
            f"bound {rows[big] * 256 * 8 / HBM_BYTES_PER_S * 1e3:.4f} ms, copy_ "
            f"{median_ms(torch, lambda: d.copy_(x)):.4f} ms")
    return out


def main() -> int:
    if not (SRC / "repro_torch" / "kernels").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script drives the port on a GPU",
              file=sys.stderr)
        return 2
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = card_facts(torch)
    build_kernels()
    errs = kernel_parity(torch, dev)

    tmpdir = ROOT / "build" / "chip_smoke"
    tmpdir.mkdir(parents=True, exist_ok=True)
    rendezvous = tmpdir / "nccl_rendezvous"
    rendezvous.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}", rank=0,
                            world_size=1)
    try:
        launches, model, opt_state = train_main_path(torch, dev)
        check_against_plain(torch, dev, model)
        step_breakdown(torch, dev, model, opt_state)
        del opt_state
        leaf_sizes = [p.numel() for p in model.parameters()]
        del model
        torch.cuda.empty_cache()
        times = timing(torch, dev, leaf_sizes)
    finally:
        dist.destroy_process_group()

    source = "src/repro_torch/csrc/fpisa_fused.cu"
    replaces = {"fused_encode_align": "src/repro/kernels/fpisa_fused.py:66",
                "fused_decode": "src/repro/kernels/fpisa_fused.py:96"}
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": float(errs[name]), "ms": times[name]["ms"],
                "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
                "bound_by": times[name]["bound_by"], "library_ms": None}
               for name in ("fused_encode_align", "fused_decode")]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
