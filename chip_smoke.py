#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints on its own lines; any failure raises, exit code != 0):

1. Card facts: the device name, ``nvidia-smi``'s name and power limit, and
   the TF32 switches (both set off: float32 products stay float32).
2. Build: compile every kernel of the port from ``src/repro_torch/csrc``;
   per library, the registers and spills ptxas reports and, from
   ``cuobjdump -sass``, how many of its instructions are IMAD forms (integer
   work the FMA pipe executes; see the rate note in phase 6); for K1's
   three modes and K2, each template's instantiations and instruction
   counts, and the main path's instantiation's loads and stores (it fails
   if the exponent mode, the wire mode or K2 there has no 16-byte load);
   for K6, each instantiation's instructions, instructions per element,
   longest loop and loads and stores (it fails if local mode at fp32, W =
   1, or leaf mode at bf16 under fp32, W = 1, has no 16-byte load).
3. Kernel parity on the card: K1 (local mode ``fpisa_encode_align``,
   exponent mode ``fpisa_block_max``, wire mode ``fpisa_encode_wire``) and
   K2 (``fpisa_decode_fused``, into every dtype) against their plain
   PyTorch versions on the same CUDA tensors, over the CPU suite's sweep
   plus +-0, denormals, +-inf, NaN (quiet and signalling, both signs), the
   range edges and the wire dtypes' extreme values, the new modes at every
   (format, leaf dtype) pair they read, k = 1 and 4 workers, block
   exponents -5..40 off the block max, and at the main path's largest
   leaf; then a 4-worker aggregation on one card per wire width: K1's local
   mode on 4 gradient tensors, MAX of block exponents, residual shift and
   wire cast, integer sum, K2; and the same workers through the exponent
   mode, the wire mode and K2 in the leaf's dtype, at fp32 and bf16 leaves,
   which must give the same bits. Then K3 (``fpisa_extract``), K4
   (``fpisa_align``, preshift 0/2), K5 (``fpisa_decode``, preshift 0/2) and
   K6 in local mode (``fpisa_accum``, W in {1, 2, 3, 4, 8} x
   ``fpisa_a``/``full``, with inputs that make FPISA-A overwrite, shift
   left into the headroom and wrap the int32 register) over the same sweep
   and the largest leaf, and in leaf mode (``fpisa_accum_leaf``: the leaf's
   dtype in and out) at every (format, leaf dtype) pair it reads, with the
   non-finite words and the same FPISA-A edges, plus a ragged row and a
   base off the 16-byte boundary in both modes.
   Tolerance: none, outputs are compared as integers (bit patterns), and
   ``max_abs_err`` is the largest absolute difference of those integers.
4. Training (the main path): qwen1.5-0.5b at full width (24 layers,
   d_model 1024, vocab 151936; bf16 weights from a seed), 3 steps of global
   batch 8 x seq 512 through ``train_loop`` with FPISA aggregation on the
   ``auto`` backend, inside an NCCL process group of one rank so the
   collectives really run. The kernels' launch counts are zeroed just
   before and read just after: K1's exponent and wire modes and K2 (into
   the leaf's bf16) must each have launched once per gradient leaf per
   step and K1's local mode never (no shift, wire cast or dtype cast runs
   between the kernels and the collectives), A1 (the attention) forward
   twice per layer per step (the remat recompute) and backward once. Then,
   on the trained model's gradients, the cuda and the plain aggregation
   must give the same bits, a profiled cuda aggregation of them must run no
   device op but K1's modes, K2 and NCCL's, and the loss of the smoke
   config must agree between the two backends.
   A breakdown of one step by phase (forward+backward, aggregation,
   optimizer) follows: the train step's own phase spans, their device
   times (CUDA events).
5. Training with switch-arrival aggregation (the ``fpisa_seq`` path): the
   same model, batch and group, 3 steps with ``strategy="fpisa_seq"`` on
   the ``auto`` backend. K6's launch counts are zeroed just before and read
   just after: one leaf-mode launch per gradient leaf per step, on the
   leaf's bf16 gathered as it is, and no local-mode launch (no upcast,
   staging cast or downcast runs around K6). Then the cuda and the plain
   ``fpisa_seq`` aggregation of the trained model's gradients must give
   the same bits, a profiled cuda ``fpisa_seq`` aggregation of them must
   run no device op but K6's and NCCL's, and the step's breakdown
   follows.
6. Timing at the main path's shapes (the 14 gradient leaves of one step,
   1,812,452 rows of 256, bf16, and the largest leaf alone): CUDA events,
   median of 25 timed runs after warm-up, for each kernel (K1 as the path
   runs it, exponent then wire mode, and each of its modes; K2 into bf16
   and into fp32), its plain version, and a ``copy_`` of the same bytes
   (the bandwidth this card reaches); then one step's aggregation passes
   without the collectives, the eager-glue composition the cuda backend ran
   before the modes against the modes', host issue and CUDA events. The
   bound is the larger of the bytes over 3.35 TB/s (H100 SXM data sheet)
   and the integer operations over the card's instruction issue rate,
   33.45 TOP/s (``PEAK_INT_OPS_PER_S`` below says how it is derived); the time
   of the operations at the INT32 pipe's own rate, 16.7 TOP/s, is logged
   beside it. No single PyTorch call computes FPISA encode, decode or the
   switch-arrival sum, so ``library_ms`` is null.
7. The two-pass pipeline at those shapes: ``ops.decode(ops.align(
   *ops.extract(x), p), p)`` over the 14 leaves must equal the fused
   ``ops.decode_fused(arshift(ops.encode_align(x), p), p)`` bit for bit at
   preshift p = 0 and 2 (the residual shift on the fused side); K3, K4 and
   K5's launch counts are zeroed just before that run and read just after
   (one extract per leaf, one align and one decode per leaf and preshift).
   Then K3, K4 and K5 are timed as above at preshift 0.
8. K6 at the ``fpisa_seq`` step's shape (W = 1, the 14 leaves): leaf mode
   at bf16 (the path's) beside the eager composition it replaced (the
   float32 upcast, local mode, the cast back: same bits, host issue and
   CUDA events in turns) and local mode at fp32; local mode at the
   accuracy shape (W = 8 stacked gradients of the embedding leaf's shape,
   both variants, each held against its plain version); one step's
   ``fpisa_seq`` aggregation through the Aggregator, W = 1 and stacked W
   = 4, host issue and CUDA events.
9. ``switch_emu`` at smoke size (its numpy dataplane is a per-packet loop on
   the host): 3 smoke steps of ``switch_emu`` and of ``fpisa_seq`` give the
   same losses (rtol 1e-6: the card's float backward sums in a varying
   order), and one leaf through both aggregators gives the same bits.

After phase 5, in the same group, bucketed aggregation (``bucketed_path``):
the replay profiler on the card feeds the cost model and ``--bucket-bytes
auto``'s choice for the 14 gradient leaves; 3 full-width steps with that
``bucket_bytes`` (K1 and K2 once per bucket per step, counts zeroed just
before and read just after); bucketed, plain, chunked, hierarchical and
bucketed ``fpisa_seq`` aggregation of the trained gradients bit-equal to
per-leaf; the bucketed step's breakdown against the per-leaf one and the
traced encode / collective / finish sums.

Then, in the same group, the logical-worker path (``stacked_path``): W = 4
logical workers on the one rank (k = 4, 2 sequences each), 3 full-width
steps through ``make_train_step(logical_workers=4)`` with stacked ``fpisa``
(K1 and K2 once per leaf per step, counts zeroed just before and read just
after; K1 over the 4 workers' rows) and 3 with stacked ``fpisa_seq`` (K6
once per leaf per step at W = 4); on the trained per-worker gradients the
cuda and plain stacked aggregations give the same bits, and bucketed
stacked ``fpisa`` (32 MiB) equals per-leaf stacked; K6 ran in leaf mode
only; the stacked step's
breakdown; ``[determinism]``: which gradient leaves and which ops alone
repeat their bits on the card with and without deterministic algorithms
(``runtime.elastic.reproducible``), and the forward+backward time of each
mode; ``[ckpt]``: checkpointed resume through ``train_loop(ckpt_dir=)``
(2 steps with a bundle after step 1, a resume to step 3) bit-equal in loss,
parameters and moments to an uninterrupted run, in the default mode, then
one bundle saved and restored on its own (bytes, seconds) and the directory
removed (the phase fails if the disk cannot hold two bundles); K1, K2 and
K6 timed at the stacked shapes (K6 in both modes, leaf mode beside the
composition it replaced).

Then, in the same group, the paper's Fig. 9 gate at full width (``fig9_path``,
``[fig9]`` lines, each with the card's name and power limit; the
reference's tests/test_convergence.py, whose port
tests/test_torch_convergence.py runs it at smoke size on the CPU):
qwen1.5-0.5b from seed 0, 30 logical-worker steps (W = 4, 2 x 512 each)
with the config's AdamW (lr 3e-4) and the gate's 5 warm-up steps, on
numpy-seeded batches with the gate's 8-token motif at positions 0-8 and
16-24 of every 32, once with the float sum of the four workers' gradients
(the ``fig9_native`` path) and once with their FPISA-A sum through K6 at
W = 4 (``fig9_fpisa_seq``), then the float sum once more (the card's own
run-to-run gap, printed beside the gate's). It fails unless both curves learn (last loss < 0.9 x
the first), the mean relative gap over the last 10 steps is under 0.05, K6
launched once per leaf per step in the ``fpisa_seq`` run and never in the
``native`` one, and A1 launched as the 4 workers' remat'd passes need,
every launch on the tensor cores; it prints both curves, each run's wall
time, the per-step median on CUDA events, peak memory and K6's share of a
profiled ``fpisa_seq`` step.

Then, in the same group, the serving path (``serve_path``): full-width
qwen1.5-0.5b (bf16 weights from a seed) through ``repro_torch.serve``.
(a) one ``decode_step_paged`` equals ``decode_step`` bit for bit at 16 rows
with 64 pages x 16 = max_len 1024, on caches holding the same prefill; the
continuous engine (16 slots, max_len 1024, pages of 16) serves a seeded
Poisson trace of 32 requests (prompts 64/256/512, budgets 32/64/128, rate
0.5 per step) and the static engine (batch 16) the same requests, both with
``fpisa`` telemetry (the ``serve`` path); (c) the telemetry totals equal the
host counts; (d) K1 and K2 launch once per telemetry flush; (b) on 6
requests the continuous engine's tokens equal the static engine's run one
request at a time, a differing token passing only where the oracle's top-2
logit gap is no larger than the largest |logit difference| of the two
paths' rows at that step (each divergence printed); 8 requests with
``fpisa_seq`` telemetry (the ``serve_fpisa_seq`` path, K6's leaf mode once per flush,
traced); a decode step and prefills on CUDA events; ``[diagnose] serve
decode``. Before the engines, ``make_serve_steps``' prefill and decode
(``train/step.py``) give the model methods' greedy tokens, the logits bit
for bit (4 rows, a 64-token prompt, 8 steps).

Then, in the same group, the model families (``models_path``, ``[models]``
lines, each with the card's name and power limit): (a) mamba2-780m, the
whole published config (48 layers, d_model 1536, state 128, vocab 50280;
bf16 weights from a seed), 3 steps of 8 x 512 through ``train_loop`` with
``fpisa`` (K1/K2 once per gradient leaf per step, the leaves counted from
the tree), cuda == plain aggregation of its gradients, the step's breakdown
and peak memory, ``[diagnose]`` of a forward+backward, then the static
engine serving 8 seeded requests with ``fpisa`` telemetry (exact totals,
K1/K2 once per flush; the ``mamba2`` path); (b) zamba2-7b at full width
(d_model 3584, d_ff 14336, state 64, the shared attention block after every
6 mamba blocks) with ``num_layers`` cut to 7 (one group and one tail block),
3 steps of ``fpisa_seq`` (K6's leaf mode once per leaf per step; the ``zamba2_seq``
path), cuda == plain ``fpisa_seq`` bits, the step's breakdown; (c)
arctic-480b at full width (128 experts top-2, d_ff 4864, moe_dense_ff 4864,
56 / 8 heads) with ``num_layers`` cut to 1: paged == dense decode bit for
bit at 16 rows, the continuous engine on a seeded 16-request trace with
``fpisa`` telemetry (exact, K1 = K2 = flushes; the ``arctic_serve`` path),
a 16-slot decode step on CUDA events against its byte bound (every step
reads all 128 experts' weights, 26.78 GB, 7.99 ms at 3.35 TB/s) and its
``[diagnose]``, and the expert queues that overflowed; (d) qwen1.5-0.5b at
full width trained 3 steps of 8 x 512 with ``remat="dots"`` (selective
checkpointing that keeps the products with no batch dimension; the ``dots``
path: K1/K2 once per leaf per step, A1 forward twice and backward once per
layer per step), then its forward+backward under remat "full", "none" and
"dots" (CUDA events, peak memory, A1's launches of each), "dots"'s loss
bit for bit and its gradients against "full"'s (bit for bit where "full"
repeats "none"'s bits, else within ``DOTS_TOL``); the group's wall time.

Then, in the same group, the encoder-decoder (``encdec_path``, ``[encdec]``
lines, each with the card's name and power limit): (a) whisper-medium at
its published size (24 encoder and 24 decoder layers, d_model 1024, 16
heads, d_ff 4096, vocab 51865, 1500 frames; 812,036,096 parameters in 26
leaves, bf16 weights from a seed), 3 steps of 8 x 448 decoder tokens (its
published ``max_target_positions``) over 8 x 1500 seeded frames through
``train_loop`` with ``fpisa`` (K1/K2 once per leaf per step; the
``whisper`` path), cuda == plain aggregation of its gradients on the batch
training feeds, the step's breakdown, decoder tokens/s and frames/s, peak
memory, ``[diagnose]`` of a forward+backward; (b) its serving half on a
float32 copy of the trained weights (8 rows of 1500 seeded frames, a
4-token prompt): prefill's logits == ``forward``'s last position and each
of 32 greedy ``decode_step``s == a fresh ``forward`` over the extended
tokens at that position, within ``WHISPER_ATOL`` (2e-4 absolute), and the
cached cross K/V == ``encode_cross_kv`` of the encoder states bit for bit;
then, in bf16, prefill and a decode step at 8 and 16 rows on CUDA events
against the step's byte bound (the decoder's weights but the cross
``wk``/``wv``, the head, and every row's cross K/V), and ``[diagnose]`` of
the 16-row step; the group's wall time.

Then, in the same group, the sharding rules, pipeline stages and dry run
(``sharding_path``, ``[sharding]`` lines, each with the card's name and
power limit): (a) qwen1.5-0.5b at full width, 3 steps of ``fpisa``
through ``train_loop`` twice from seed 0 under deterministic algorithms:
plain tensors, then on the card's ``("data", "model")`` = (1, 1)
``DeviceMesh`` with the parameters and AdamW moments DTensors placed by
``sharding/rules.py`` (the ``sharded`` path: K1/K2 once per leaf per step,
counted from zero over the mesh run); losses, parameters, moments and the
aggregated gradients of the training batch held bit for bit to the plain
run's; the two steps' and forward+backwards' times; (b) the GPipe loss
(``train/pipeline.py``) at full width, one stage, 4 microbatches, against
``model.loss`` (2e-3 on the loss; rtol 2e-2, atol 2e-4 on every gradient,
the reference test's tolerances); (c) ``launch/opscan.py`` over one mesh
step: flops, bytes, ``compute_s`` and ``memory_s`` at the H100 constants
(``launch/mesh.py``) beside the measured step; and ``python -m
repro_torch.launch.dryrun`` of qwen1.5-0.5b and kimi-k2 (multi-pod)
``train_4k``, traced on the host beside the card's work, their
``per_device.arg_bytes`` against the card's memory.

Then, in the same group, long context through A1, the port's CUDA kernel for
the reference's chunked (online-softmax) attention (``longctx_path``,
``[longctx]`` lines, each with the card's name and power limit): (a) A1
forward and backward against its plain version (the reference's loop,
``kernels/attention.py::chunked_attention_ref``) on the same card tensors:
output and q/k/v gradients, causal and not, float32 and bf16, at qwen's 16
heads of 64, batch 2, S = 512, 1,024 and 4,096 with cq = ck = 32, then in
bf16 at the shapes the bf16 paths give A1 (the main path's 8 x 512 in
one chunk, (b)'s 4 x 4,096 in chunks of 2,048, whisper's 1,500-frame
encoder, 448-token decoder and cross-attention, zamba2's 8 x 512 at 32
heads of 112, arctic's prefills at 56 heads of 128), within ``A1_TOL`` of the
plain result's largest |entry|, and in bf16 each of the two against the
plain version in float32; (b) qwen1.5-0.5b at full width
trained at the reference's train_4k length: 3 steps of 4 x 4,096 with
``fpisa`` and remat "full" (path ``longctx``: K1/K2 once per leaf per step,
A1 forward twice and backward once per layer per step), the step's
breakdown, tok/s, peak memory beside the float32 logits' bytes, A1's share
of a profiled forward+backward; (f) one forward+backward of (b)'s 4 x 4,096
under remat "dots" beside "full" (path ``longctx_dots``: A1 forward twice
and backward once per layer), ms, peak memory and tok/s of each; (c) one
32,768-token qwen row (prefill_32k's
length): ``prefill`` into a decode cache and 64 greedy ``decode_step``s
(path ``prefill_32k``: A1 once per layer), prefill and decode times, the
row's and the cache's K/V bytes, A1 against its plain version at the
prefill's attention shape, and on a float32 copy prefill's last logits
against a fresh ``forward``'s within ``PREFILL_ATOL``; (d) whisper-medium's
1500-frame encoder at its published size (path ``whisper_encoder``: A1
once per layer), its time, its float32 copy through A1 against the same
encoder with the plain attention within ``ENCODER_RTOL``, the bf16
encoder's distance from the copy; then A1 timed at (b)'s shape (the
kernels line), at (a)'s, at the main path's 8 x 512, at whisper's three
shapes (the 8 x 1,500 encoder, the 8 x 448 causal decoder and their 448 x
1,500 cross-attention) and at one head_dim-128 shape (2 x 4,096, 16 heads,
chunks of 2,048), against its bound (flops at 989 TFLOP/s, bytes at 3.35
TB/s), its plain version and ``scaled_dot_product_attention`` (timed as the
yardstick, used nowhere in the port). A1 takes one route per dtype: bf16
on the tensor-core kernels, float32 on the CUDA-core ones; the build
counts HGMMA (wgmma) and UTMALDG (TMA loads) in the bf16 kernels' SASS and
fails on a 0, and ``[a1 routes]`` gives each path's A1 launches by route
and fails if a (bf16) path took the float32 kernels. (e) After the main
path's breakdown, a ``[longctx] (e)`` line puts its forward+backward, now
through A1, beside the 147-186 ms that the whole (S, S) float32 softmax
took before it (PERF.md §5).

Then S1, the port's CUDA kernels for the reference's plain-jnp Mamba2 SSD
scan (``s1_line``, ``[s1]`` lines): S1 through ``models.mamba2.ssd_chunked``
and autograd against the plain version in float64 (``ssd_float64_ref``) at
zamba2-7b's 4 x 4,096 and mamba2-780m's 8 x 512 in bf16, dt in [1e-3, 0.1]:
y, the final state and dx, ddt, dA, dB, dC, dD within ``S1_TOL`` of their
largest |entry|, one forward and one backward launch a call; then its
forward and backward at the cell's shape against the bound, the plain
version and ``kernel_info()``. The training paths check S1's launches
(``check_s1_launches``: in a Mamba2 model the forward twice and the
backward once per layer per step under remat, none elsewhere).

Then O1, the port's CUDA kernels for the reference's plain-jnp AdamW
(``o1_line``, ``[o1]`` lines): at each training cell's tree (qwen1.5-0.5b's
14 leaves, Zamba2-7B's first 12 layers' 22, bf16, seeded values) one step
of ``optimizers.update`` against the eager route ``update_eager`` with the
clip inactive, p, m, v and lr bit for bit, and with the clip active the
grad_norms within 1e-6; then O1's time, its norm and update kernels' each,
against the bound (24 bytes a parameter at 3.35 TB/s), the eager route's
time and each route's host issue time, and ``kernel_info()``. The
training paths check O1's launches (``check_o1_launches``: its norm and
update kernel once a step, on plain tensors and on the DeviceMesh's
DTensors, whose local shards O1 updates; the mesh check (a) holds the two
runs' bits equal with the clip active).

Then the switch dataplane (``switchsim_path``, ``[switchsim]`` lines; the
dataplane runs as torch ops on the card, as the reference runs it as jitted
``jnp``): (a) the card's ``BatchedDataplane`` equals the port's numpy
dataplane on the host and the per-packet ``FpisaSwitch`` on the card, bits
and counters, at a small size (both variants, P = 1 and 4, drop 0 and 0.3,
a worker failure, J = 2 with overlapping quotas and priorities (1, 0));
(b) the stream: the full-width qwen1.5-0.5b MLP leaf cut to 6 of its 24
layers (6 x 1024 x 2816 = 17,301,504 elements) from each of 4 workers
through 4 pipelines x 256 slots (G = 2048, a window of 1024 chunks, up to
4,096 packets a driver round), both variants at drop 0 and 0.01, each result held bit for bit
against K6 in arrival order (the chunks grouped by their arrival
permutation, one ``ops.accum`` per group: the ``switchsim`` path's K6
launches, counted from zero over (a) and (b)); driver and inner rounds,
packets/s, stats, host wall and CUDA-event time, and one driver round's
device call profiled (host issue, events, kernels, launches per inner
round, device busy share); (c) that stream and a one-port
``StreamedGroupBySum`` query stream on one dataplane, ``job_workers=(4,
1)``, priorities (1, 0): disjoint quotas (each job bit-equal to its
single-tenant run), then a shared pool (query totals within rel 1e-4 of the
full scan), with done_round, job_stats and Jain fairness; (d) two
``switch_emu`` Aggregators on one named dataplane, card == CPU bits.
Then in-switch query processing (``query_path``, ``[query]`` lines): (e)
the uservisits adRevenue column (AMPLab Big Data Benchmark; gamma(2, 50),
float32, numpy seed 1) on the card: Top-10 over 50,000,000 rows in batches
of 1,048,576, exact against the full scan, with its prune rate; group-by
SUM of 64 groups over 262,144 rows (``full``): the timed run's planes
equal to the CPU's over the same rows, its totals within rel 2e-3 of
``spark_like_groupby``, rows/s on the card and the baseline's on the host;
(f) ``python -m repro_torch.launch.query`` on the card. Every time is
printed beside the card's name and power limit.

In the ``kernels`` line, ``launches`` is a kernel's launches summed over
every path above that ran it (main, ``fpisa_seq``, bucketed, stacked
``fpisa``, stacked ``fpisa_seq``, ``fig9_native``, ``fig9_fpisa_seq``,
``serve``, ``serve_fpisa_seq``, ``mamba2``, ``zamba2_seq``, ``arctic_serve``,
``dots``, ``whisper``, ``sharded``, ``longctx``, ``longctx_dots``,
``prefill_32k``, ``whisper_encoder``,
the two-pass pipeline, ``switchsim``) and ``launches_by_path`` names each path's count, every
path's counts zeroed just before it and read just after. K1, K2 and K6
also have ``launches_by_mode`` (per path: K1 ``local``, ``exponent``,
``wire``; K2 ``format``, ``leaf``; K6 ``local``, ``leaf``) and
``ms_by_mode`` (each mode's ms, plain ms, bound and ``copy_`` at the main
path's shapes); their ``ms`` is the main path's (K1: exponent + wire mode;
K2: into bf16; K6: leaf mode at the fpisa_seq step's bf16 leaves). A1 has two
entries, ``chunked_attention_fwd`` and ``chunked_attention_bwd`` (its dQ
and dK/dV kernels, one launch of the pair per backward), each also with
``launches_by_route`` (per path: ``wgmma``, ``cuda_cores``); their
``library_ms`` is ``scaled_dot_product_attention``'s forward and
backward, the K1-K6 entries' null.

The line before the last is ``{"kernels": [...]}`` with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repository beside it, the script exits
with code 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = None        # repro_torch.launch.mesh.HBM_BW, read in main()
# Integer operations. Each SM has 4 warp schedulers, each issuing at most one
# warp instruction (32 lanes) per clock: 128 lane-operations per clock per
# SM, 132 SMs x 128 x 1.98 GHz (SXM boost) = 33.45 TOP/s, the most any
# instruction mix can reach. The INT32 pipe alone has 64 lanes per SM (16.7
# TOP/s); integer work reaches past it because the FMA pipe executes the IMAD
# forms (IMAD, IMAD.MOV, IMAD.SHL, IMAD.IADD, ...), which ptxas emits for
# moves, constant shifts and adds (Nsight Compute's kernel profiling guide,
# pipelines "fma" and "alu"; the build phase counts them in each library).
# The bound takes the issue rate, so it stays a floor; the INT32-pipe time
# is logged beside it.
PEAK_INT_OPS_PER_S = 132 * 128 * 1.98e9
INT32_PIPE_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per element, counted from csrc/fpisa_fused.cuh (encode
# 13, row max 1, arshift with its clamp 4, renormalize 34, one FPISA-A add
# with its shifts about 15; K1's exponent mode: the exponent field 2 and the
# max 1, its wire mode: encode 13, arshift 4, wire cast and add 2; bf16
# leaves widen with one shift, K2's cast to bf16 takes 5)
OPS_PER_ELEM = {"fused_encode_align": 16, "fused_decode": 34, "fpisa_extract": 14,
                "fpisa_align": 5, "fpisa_decode": 34, "block_max": 3, "encode_wire": 20,
                "decode_leaf": 39}
KERNELS = ("fused_encode_align", "fused_decode", "fpisa_extract", "fpisa_align",
           "fpisa_decode", "fpisa_accum", "chunked_attention_fwd", "chunked_attention_bwd",
           "ssd_forward", "ssd_backward", "adamw_norm", "adamw_update")
# the port's kernels for jnp functions: A1 (the chunked attention), S1 (Mamba2's
# SSD), O1 (AdamW's clip and update)
A1 = ("chunked_attention_fwd", "chunked_attention_bwd")
S1 = ("ssd_forward", "ssd_backward")
O1 = ("adamw_norm", "adamw_update")

SWEEP = [(1, 256), (8, 128), (256, 256), (300, 512), (513, 128), (64, 512)]
EMBED_ROWS = 607744           # the embedding gradient: 151936 x 1024 / 256
FMTS = ("fp32", "fp16", "bf16")
STEPS, GLOBAL_BATCH, SEQ_LEN = 3, 8, 512
ACCUM_WORKERS = (1, 2, 4, 8)
LOGICAL_WORKERS = 4           # the stacked phase: W = 4 logical workers on one rank
# the [fig9] phase: the reference gate's steps and warm-up (its lr, 3e-3, is
# the smoke model's; the full-width runs take the config's 3e-4, PERF.md §6)
FIG9_STEPS, FIG9_WARMUP = 30, 5
KERNEL_WRAPPER = {"fused_encode_align": "encode_align", "fused_decode": "decode_fused",
                  "fpisa_extract": "extract", "fpisa_align": "align", "fpisa_decode": "decode",
                  "fpisa_accum": "accum", "chunked_attention_fwd": "attention_forward",
                  "chunked_attention_bwd": "attention_backward", "ssd_forward": "ssd_forward",
                  "ssd_backward": "ssd_backward", "adamw_norm": "adamw_norm",
                  "adamw_update": "adamw_update"}
# K1's modes, each its own wrapper in kernels/ops.py with its own count: the
# local mode (the TPU kernel's function) and the aggregation's exponent and
# wire modes. K2 counts its launches by mode in ``ops.decode_fused.modes``:
# "format" (the format's dtype out) and "leaf" (another dtype, the leaf's
# cast taken in). The kernels line gives both as ``launches_by_mode``.
K1_MODES = {"local": "encode_align", "exponent": "block_max", "wire": "encode_wire"}
K2_MODES = ("format", "leaf")
K1K2 = ("fused_encode_align", "fused_decode")
# K6's modes, counted in ``ops.accum.launches_by_mode``: "local" (ops.accum,
# the TPU kernel's float32 out) and "leaf" (ops.accum_leaf, a leaf stack in
# its own dtype, that dtype out: the fpisa_seq paths)
K6_MODES = ("local", "leaf")
# the serve phase: engines' sizes and the Poisson trace
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_PAGE = 16, 1024, 16
SERVE_REQUESTS, SERVE_RATE = 32, 0.5
SERVE_PROMPTS, SERVE_BUDGETS = (64, 256, 512), (32, 64, 128)
ORACLE_REQUESTS, SEQ_REQUESTS = 6, 8
# the models group: requests per served family, zamba2's depth cut
MODEL_REQUESTS, ZAMBA_LAYERS = 8, 7
# the encdec group: whisper-medium's size, its published max_target_positions
# (the decoder tokens of a training sequence), the serving checks' prompt
# length, greedy decode steps and rows, and the rows of the timed decode steps
WHISPER_PARAMS, WHISPER_LEAVES, WHISPER_SEQ = 812_036_096, 26, 448
WHISPER_PROMPT, WHISPER_DECODE, WHISPER_ROWS = 4, 32, (8, 16)
# the serving checks' tolerance on the float32 copy: prefill's and every
# decode step's logits against a fresh forward's at that position, absolute
# (the reference's own prefill tolerance, tests/test_models.py; its decode
# check allows 5e-3)
WHISPER_ATOL = 2e-4
# the switchsim phase: the full-width qwen1.5-0.5b MLP leaf (d_model 1024 x d_ff
# 2816 a layer) cut in depth from 24 layers to 6, from each of 4 workers,
# through 4 pipelines x 256 slots
STREAM_WORKERS, STREAM_ELEMS = 4, 6 * 1024 * 2816
SWITCH_SLOTS, SWITCH_PIPES = 256, 4
# the query phase: the uservisits adRevenue column (AMPLab Big Data Benchmark)
QUERY_ROWS, QUERY_BATCH = 50_000_000, 1_048_576
# the group-by: 64 groups over 262,144 rows, four of GroupBySum's 65,536-row
# batches (each a few seconds of eager rounds on the card and on the host);
# the profiled batch is 8,192 rows (about 20,000 launches to trace, not 160,000)
GROUPS, GROUP_ROWS, PROFILED_ROWS = 64, 262_144, 8192
# the longctx group: qwen1.5-0.5b at the reference's train_4k and prefill_32k
# lengths (configs/base.py SHAPES), A1 against its plain version at qwen's
# heads (16 x 64) and batch 2 with cq = 32, whisper's 1500-frame encoder
LONG_TRAIN_BATCH, LONG_TRAIN_SEQ = 4, 4096
REMATS = ("full", "none", "dots")
# "dots"'s gradients against "full"'s where the card's "full" does not repeat
# "none"'s bits: a bf16 gradient's rounding step is 2^-8 of its magnitude
DOTS_TOL = 1e-2
LONG_PREFILL, LONG_DECODE = 32768, 64
A1_SEQS, A1_BATCH, A1_CHUNK = (512, 1024, 4096), 2, 32
# A1 against its plain version, relative to the plain result's largest |entry|
# (output, gradients); tests/test_torch_cuda.py states the same and why
A1_TOL = {"float32": (1e-5, 2e-5), "bfloat16": (1e-2, 6e-2)}
# the 32,768-token prefill against a fresh forward, on a float32 copy: absolute,
# the reference's own prefill tolerance (as WHISPER_ATOL)
PREFILL_ATOL = 2e-4
# whisper's encoder on a float32 copy through A1 against the same encoder with
# the plain attention, relative to the largest |state|: 24 layers of A1's
# float32 rounding (at most 3.1e-6 a call)
ENCODER_RTOL = 1e-4
CARD = "card not read yet"    # nvidia-smi's name and power limit, beside every number


def accum_ops_per_elem(workers: int, bf16_leaf: bool = False) -> int:
    """K6's integer operations per element: the fewest of the card's
    instructions the function needs (a three-input LOP3 or IADD3, a min,
    max or select count one each; loads, stores, address math and loop
    control are left out). Per worker the encode (8: the exponent field 2,
    mantissa and implied one 1, the inf/NaN clamp 2, the denormal flush 1,
    the sign 2) and the add (7: the exponent difference 1, two clamped
    shift distances 2, two shifts 2, the add 1, the exponent 1), then one
    renormalize (8: the round-down conversion 1, its exponent 2, the new
    exponent 1, the range test 2, the result and its select 2); a bf16 leaf
    adds its widening (1 a worker) and the round to nearest even back (3).
    Not derived from the compiled kernel, so more instructions there do not
    loosen the bound; ``check_k6_sass`` holds it under the compiled count."""
    return 15 * workers + 8 + (workers + 3 if bf16_leaf else 0)


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
    global CARD
    CARD = smi[0].strip()
    log(f"[card] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return name


# one SASS instruction's opcode in ``cuobjdump -sass`` output
SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def build_kernels():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} librar{'y' if len(libs) == 1 else 'ies'} in "
        f"{time.perf_counter() - t0:.1f} s: " + ", ".join(p.name for p in libs.values()))
    log("[build] each source's nvcc, all started together (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(_build.BUILD_SECONDS.items())))
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    for stem, lib in libs.items():
        report = lib.with_name(lib.name + ".log")
        if report.is_file():  # nvcc -Xptxas -v of this build
            text = report.read_text()
            regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
            spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", text))
            log(f"[build] {stem} ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} "
                f"registers per thread, {spills} bytes of spill stores")
            if stem == "chunked_attention":
                for entry in text.split("Compiling entry function '")[1:]:
                    name, used = entry.split("'", 1)[0], re.search(r"Used (\d+) registers", entry)
                    spill = re.search(r"(\d+) bytes spill stores", entry)
                    log(f"[build] {stem} {a1_kernel_name(name)}: {used and used.group(1)} "
                        f"registers, {spill and spill.group(1)} bytes of spill stores")
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        opcodes = SASS_OPCODE.findall(sass)
        imad = sum(op.startswith("IMAD") for op in opcodes)
        log(f"[build] {stem} sass: {len(opcodes)} instructions, {imad} IMAD forms "
            f"({100 * imad / max(len(opcodes), 1):.1f} %, integer work on the FMA pipe)")
        if stem == "chunked_attention":
            a1_sass_check(sass)
        cufilt = cuobjdump.with_name("cu++filt")
        cufilt = str(cufilt) if cufilt.is_file() else shutil.which("c++filt")
        if stem == "fpisa_fused":
            k1k2_sass_record(sass, cufilt)
        if stem == "fpisa_accum":
            check_k6_sass(k6_sass_record(sass, cufilt))


# the main path's instantiation of each K1 mode and of K2 (fp32 format,
# bf16 leaves, 32-bit wire, blocks of 256), as cu++filt names them
K1K2_MAIN = {"local mode": "encode_align_kernel<fpisa::Format<8, 23>, unsigned int, 256>",
             "exponent mode": "block_max_kernel<fpisa::Format<8, 23>, 2, 256>",
             "wire mode": "encode_wire_kernel<fpisa::Format<8, 23>, 2, 32, 256>",
             "K2 into bf16": "decode_kernel<fpisa::Format<8, 23>, int, 2, 256>"}


def sass_functions(sass, cufilt):
    """{kernel name: its SASS text} of ``cuobjdump -sass`` output, the names
    demangled by ``cufilt`` where there is one and written without casts
    and spaces (cu++filt may write a template argument as "(int)2")."""
    bodies = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name, rest = body.split("\n", 1)
        bodies[name.strip()] = rest
    names = list(bodies)
    if cufilt:  # demangle
        names = subprocess.run([cufilt], input="\n".join(names), capture_output=True,
                               text=True, timeout=60, check=True).stdout.splitlines()
    return {re.sub(r"\((?:unsigned |bool)?(?:int)?\)|\s", "", n): b
            for n, b in zip(names, bodies.values())}


def sass_loop(body):
    """Instructions in the longest backward branch's span of one kernel's
    SASS text (a loop's body; 0 where the code is straight)."""
    spans = [(int(at, 16) - int(to, 16)) // 16 + 1 for at, to in re.findall(
        r"/\*([0-9a-f]{4,})\*/[^;\n]*?\bBRA\s+(?:`\()?0x([0-9a-f]+)", body)]
    return max([s for s in spans if s > 0], default=0)


def memory_opcodes(opcodes):
    """The global load and store opcodes among ``opcodes``."""
    return {"loads": sorted({o for o in opcodes if o.startswith("LDG")}),
            "stores": sorted({o for o in opcodes if o.startswith("STG")})}


def k1k2_sass_record(sass, cufilt):
    """K1's modes and K2 in ``cuobjdump -sass`` of csrc/fpisa_fused.cu: per
    kernel template, its instantiations and their instruction counts; for
    the main path's instantiation of each (``K1K2_MAIN``), its instruction
    count and its global load and store opcodes. Raises if the exponent
    mode, the wire mode or K2 at the main path's shape has no 16-byte load
    (LDG.E.128)."""
    ops_of = {n: SASS_OPCODE.findall(b) for n, b in sass_functions(sass, cufilt).items()}
    families = {}
    for name, opcodes in ops_of.items():
        fam = next((f for f in ("encode_align_kernel", "block_max_kernel",
                                "encode_wire_kernel", "decode_kernel") if f in name), None)
        if fam:
            families.setdefault(fam, []).append(len(opcodes))
    log("[build] fpisa_fused SASS by kernel template (instantiations, instructions): "
        + json.dumps({f: [len(n), min(n), max(n)] for f, n in families.items()}))
    main = {}
    for mode, want in K1K2_MAIN.items():
        found = [ops_ for name, ops_ in ops_of.items() if want.replace(" ", "") in name]
        if not found:
            fam = want.split("<")[0]
            raise AssertionError(f"{mode}: {want} not in the SASS; the {fam} names: "
                                 f"{[n for n in ops_of if fam in n][:3]}")
        main[mode] = {"instructions": len(found[0]), **memory_opcodes(found[0])}
    log("[build] fpisa_fused SASS, the main path's instantiations: " + json.dumps(main))
    for mode in ("exponent mode", "wire mode", "K2 into bf16"):
        if not any(o.startswith("LDG.E.128") for o in main[mode]["loads"]):
            raise AssertionError(f"{mode}: no 16-byte load in the SASS of "
                                 f"{K1K2_MAIN[mode]}: {main[mode]}")


# K6's kernel template (csrc/fpisa_accum.cu): accum_kernel<format, input
# dtype, output dtype, full, W>, dtype codes 0 = fp32, 1 = fp16, 2 = bf16, W
# = 0 the runtime loop over the workers; a thread takes K6_WORDS[W] 16-byte
# words of 16 / itemsize elements. The main paths' instantiations must load
# 16-byte words: local mode at the fp32 format, W = 1 (the TPU kernel's
# function at the fpisa_seq step's shape), and leaf mode at bf16 leaves
# under the fp32 format, W = 1 (the fpisa_seq paths).
K6_KERNEL = re.compile(r"accum_kernel<fpisa::Format<(\d+),(\d+)>,(\d),(\d),(\d),(\d)>")
K6_WORDS = {1: 4, 2: 2, 4: 1, 8: 1}
K6_MAIN = {"local mode, fp32, W = 1": ("8", "23", "0", "0", "0", "1"),
           "leaf mode, bf16 under fp32, W = 1": ("8", "23", "2", "2", "0", "1")}


def k6_sass_record(sass, cufilt):
    """K6 in ``cuobjdump -sass`` of csrc/fpisa_accum.cu: each instantiation's
    instruction count, instructions per element (the count over the
    elements a thread takes; straight-line code at a templated W), its
    global loads and stores per element and their opcodes. Returns
    {template arguments: record}."""
    record = {}
    for name, body in sass_functions(sass, cufilt).items():
        name = name.replace("false", "0").replace("true", "1")
        opcodes = SASS_OPCODE.findall(body)
        m = K6_KERNEL.search(name)
        if m:
            _, _, din, _, _, w = m.groups()
            elems = K6_WORDS.get(int(w), 0) * (4 if din == "0" else 8)
            key = ",".join(m.groups())
        elif "accum" in name:  # one element a thread (the edges' kernel, the first design)
            elems, key = 1, re.sub(r"^.*?(\w*accum\w*<[^(]*>?)\(.*$", r"\1", name)
        else:
            continue
        imad = sum(op.startswith("IMAD") for op in opcodes)
        memory = sum(op.startswith(("LDG", "STG")) for op in opcodes)
        record[key] = {"instructions": len(opcodes),
                       "per_element": round(len(opcodes) / elems, 1) if elems else None,
                       "imad_per_element": round(imad / elems, 1) if elems else None,
                       "memory_per_element": round(memory / elems, 2) if elems else None,
                       "loop": sass_loop(body), **memory_opcodes(opcodes)}
    log("[build] fpisa_accum SASS (format exp,man, input dtype, output dtype, full, W: "
        "instructions, per element, IMAD forms per element (the FMA pipe's share), the "
        "longest loop's body, loads, stores): " + json.dumps(
            {k: [r["instructions"], r["per_element"], r["imad_per_element"], r["loop"],
                 r["loads"], r["stores"]] for k, r in record.items()}))
    return record


def check_k6_sass(record):
    """Raises unless K6's main instantiations (``K6_MAIN``) load 16-byte
    words (LDG.E.128), and unless the operations the bound counts
    (``accum_ops_per_elem``) are at most the compiled instructions per
    element net of loads and stores, in each fp32-format instantiation the
    timing phase bounds (local mode at fp32, leaf mode at bf16; W 1, 2, 4,
    8; both variants)."""
    for what, args in K6_MAIN.items():
        got = record.get(",".join(args))
        if not got or not any(o.startswith("LDG.E.128") for o in got["loads"]):
            raise AssertionError(f"K6 {what}: no 16-byte load in the SASS of accum_kernel"
                                 f"<{','.join(args)}>: {got}")
    for key, got in record.items():
        args = key.split(",")
        if args[:2] != ["8", "23"] or args[2] not in ("0", "2") or int(args[5]) not in K6_WORDS:
            continue
        w, leaf = int(args[5]), args[2] == "2"
        net = got["per_element"] - got["memory_per_element"]
        if accum_ops_per_elem(w, bf16_leaf=leaf) > net:
            raise AssertionError(f"K6 accum_kernel<{key}>: the bound counts "
                                 f"{accum_ops_per_elem(w, bf16_leaf=leaf)} operations an "
                                 f"element, the SASS has {net} besides loads and stores")
    log("[build] fpisa_accum SASS, the main paths' instantiations: " + json.dumps(
        {what: record[",".join(args)] for what, args in K6_MAIN.items()}))


def a1_kernel_name(mangled):
    """``attn_fwd_tc<1>`` (bf16, NP panels) or ``attn_fwd<float, 1>`` from
    A1's mangled kernel name."""
    m = re.search(r"(attn_\w+?)I(\w*?)Li(\d)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{'float, ' if m.group(2) == 'f' else ''}{m.group(3)}>"


def a1_sass_check(sass):
    """A1's bf16 kernels (``attn_*_tc``, the set ``attention.TC_KERNELS``
    names) run their products on the tensor cores and take their operands
    by TMA: count HGMMA and UTMALDG in each one's SASS, and raise where
    either is 0 or the set differs."""
    from repro_torch.kernels.attention import TC_KERNELS

    counts = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if "_tc" in name:
            ops_ = SASS_OPCODE.findall(body)
            wide = re.search(r"(attn_\w+?_tc_wide)E", name)  # not a template: no <N>
            key = wide.group(1) if wide else re.sub(r"^.*?(attn_\w+_tc)ILi(\d)E.*$", r"\1<\2>",
                                                    name)
            counts[key] = {
                "HGMMA": sum(op.startswith("HGMMA") for op in ops_),
                "UTMALDG": sum(op.startswith("UTMALDG") for op in ops_)}
    log(f"[build] chunked_attention bf16 kernels' SASS (HGMMA = wgmma, UTMALDG = TMA load): "
        + json.dumps(counts))
    if set(counts) != set(TC_KERNELS) or not all(c["HGMMA"] and c["UTMALDG"]
                                                 for c in counts.values()):
        raise AssertionError(f"A1's bf16 kernels lack wgmma or TMA in their SASS: {counts}")


class Parity:
    """Kernel-vs-plain comparisons; records the largest integer difference."""

    def __init__(self, torch):
        self.torch = torch
        self.err = dict.fromkeys(KERNELS, 0)
        self.cases = dict.fromkeys(KERNELS, 0)

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


# (format, leaf dtype) pairs K1's exponent and wire modes read as they are;
# each dtype's NaN words of both signs (quiet and signalling), largest finite
# value, smallest normal and a denormal, written into a leaf after sample's
LEAF_PAIRS = (("fp32", "fp32"), ("fp32", "bf16"), ("fp32", "fp16"), ("fp16", "fp16"),
              ("bf16", "bf16"))
RAW_SPECIALS = {"fp32": (0x7FC00000, -0x400000, 0x7F800001, -0x7FFFFF, 0x7F7FFFFF, 0x00800000,
                         0x00000001),
                "bf16": (0x7FC0, -0x40, 0x7F81, -0x7F, 0x7F7F, 0x0080, 0x0001),
                "fp16": (0x7E00, -0x200, 0x7C01, -0x3FF, 0x7BFF, 0x0400, 0x0001)}


def leaf_sample(torch, shape, leaf, seed, dev):
    """``sample``'s values in dtype ``leaf`` with RAW_SPECIALS[leaf] after
    its specials (as int words: -0x40 is 0xFFC0)."""
    from repro_torch.core.fpisa import PACKED_DTYPE

    x = sample(torch, shape, leaf, seed, dev)
    words = torch.tensor(RAW_SPECIALS[leaf], device=dev,
                         dtype=torch.int32 if leaf == "fp32" else torch.int16)
    n = max(0, min(len(words), x.numel() - 8))
    x.view(-1)[8:8 + n] = words[:n].view(PACKED_DTYPE[leaf])
    return x


def mode_parity(torch, dev, par):
    """K1's exponent and wire modes and K2 into the leaf's dtype against
    their plain versions: over SWEEP x LEAF_PAIRS x k in {1, 4} with the
    non-finite words, block exponents offset -5..40 from the block max (the
    shift clamps at both ends), wires 32/16/8; K2 into every dtype of every
    format."""
    from repro_torch.core import fpisa
    from repro_torch.kernels import ops, ref

    for shape in SWEEP:
        for i, (fmt, leaf) in enumerate(LEAF_PAIRS):
            f = fpisa.FORMATS[fmt]
            for k in (1, 4):
                x = torch.stack([leaf_sample(torch, shape, leaf, 17 * i + j + shape[0], dev)
                                 for j in range(k)])
                what = f"{fmt} from {leaf} k{k} {shape}"
                bmax_r = ref.block_max_ref(x, f)
                par.check("fused_encode_align", ops.block_max(x, fmt), bmax_r,
                          f"exponent mode {what}")
                gen = torch.Generator(device=dev).manual_seed(shape[1] + k + i)
                be = bmax_r + torch.randint(-5, 41, bmax_r.shape, generator=gen, device=dev,
                                            dtype=torch.int32)
                for wire in (32, 16, 8):
                    pre = wire % 3
                    plane = ops.encode_wire(x, be, pre, wire, fmt)
                    plane_r = ref.encode_wire_ref(x, be, pre, wire, f)
                    par.check("fused_encode_align", plane, plane_r,
                              f"wire mode {what} wire {wire} preshift {pre}")
                    par.check("fused_decode", ops.decode_fused(plane, be, pre, fmt, x.dtype),
                              ref.fused_decode_ref(plane_r, be, pre, f, x.dtype),
                              f"leaf-dtype K2 {what} wire {wire}")
        for fmt in FMTS:
            for wire in (torch.int8, torch.int16, torch.int32):
                m = wire_sample(torch, shape, wire, shape[0] + 5, dev)
                gen = torch.Generator(device=dev).manual_seed(shape[1] + 5)
                be = torch.randint(0, fpisa.FORMATS[fmt].exp_mask + 2, (shape[0],),
                                   generator=gen, device=dev, dtype=torch.int32)
                for out in FMTS:
                    dt = fpisa.PACKED_DTYPE[out]
                    par.check("fused_decode", ops.decode_fused(m, be, 1, fmt, dt),
                              ref.fused_decode_ref(m, be, 1, fpisa.FORMATS[fmt], dt),
                              f"K2 {fmt} to {out} {shape} {wire}")


def kernel_parity(torch, dev, par):
    from repro_torch.core import fpisa
    from repro_torch.core import numerics as nx
    from repro_torch.core.allreduce import _wire_shift
    from repro_torch.kernels import ops, ref

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
        # the same 4 workers through the aggregation's modes, fp32 leaves and
        # bf16 leaves: the block max over the stack, one shift, the wire
        # cast and the fold in wire mode, K2 in the leaf's dtype; it must
        # give the local-mode composition's bits
        for leaf in (torch.float32, torch.bfloat16):
            x4 = torch.stack(xs).to(leaf)
            b = ops.block_max(x4, "fp32")
            kern = ops.decode_fused(ops.encode_wire(x4, b, shift, bits, "fp32"), b, shift,
                                    "fp32", leaf)
            b_r = ref.block_max_ref(x4, fpisa.FP32)
            plain = ref.fused_decode_ref(ref.encode_wire_ref(x4, b_r, shift, bits, fpisa.FP32),
                                         b_r, shift, fpisa.FP32, leaf)
            par.check("fused_encode_align", b, b_r, f"4-worker exponent mode, {leaf}")
            par.check("fused_decode", kern, plain,
                      f"4-worker composition through the modes, {bits}-bit wire, {leaf}")
            old = got if leaf == torch.float32 else compose(
                lambda x: ops.encode_align(x.to(leaf).float(), "fp32"),
                lambda m, b: ops.decode_fused(m, b, shift, "fp32")).to(leaf)
            if not torch.equal(kern.view(torch.int16), old.view(torch.int16)):
                raise AssertionError(f"the modes' 4-worker composition differs from the local "
                                     f"mode's at the {bits}-bit wire, {leaf}")
    mode_parity(torch, dev, par)
    torch.cuda.synchronize()
    log(f"[parity] bit-equal to the plain versions: fused_encode_align (K1, all three modes) "
        f"{par.cases['fused_encode_align']} cases, fused_decode "
        f"{par.cases['fused_decode']} cases (sweep {SWEEP} x {FMTS}, wires i8/i16/i32, "
        f"preshift 0/2, the embedding leaf, 4-worker composition at wire 32/16/8 through "
        f"the local mode and through the exponent and wire modes at fp32 and bf16 leaves, "
        f"equal to each other; the modes over {LEAF_PAIRS} x k 1/4 with the non-finite "
        f"words, K2 into every dtype)")


def accum_sample(torch, workers, shape, fmt, seed, dev):
    """(W, R, B) gradient-like stack; row 0 forces FPISA-A's edges: columns
    0..4 hold the largest mantissa at exponent = headroom from every worker
    (each is shifted left by the full headroom into the exponent-0
    accumulator, and the second one wraps the int32 register), column 4
    from worker 1 at headroom + 1 (it overwrites the accumulator)."""
    from repro_torch.core import fpisa

    f = fpisa.FORMATS[fmt]
    x = torch.stack([sample(torch, shape, fmt, seed + i, dev) for i in range(workers)])
    bits = x.view(torch.int32 if fmt == "fp32" else torch.int16)
    bits[:, 0, :5] = (f.headroom << f.man_bits) | f.man_mask
    bits[1:2, 0, 4] = ((f.headroom + 1) << f.man_bits) | f.man_mask
    return x


def leaf_accum_sample(torch, workers, shape, fmt, leaf, seed, dev):
    """(W, *shape) stack of ``leaf_sample``'s values in dtype ``leaf`` (the
    non-finite words and range edges included); where the leaf dtype has
    the format's exponent range (its own dtype, bf16 under fp32), row 0
    also holds ``accum_sample``'s FPISA-A edges: the largest mantissa at
    exponent = headroom from every worker in columns 0..4 (shifted left
    into the exponent-0 accumulator, the second one wrapping the register),
    column 4 from worker 1 at headroom + 1 (an overwrite)."""
    from repro_torch.core import fpisa

    x = torch.stack([leaf_sample(torch, shape, leaf, seed + i, dev) for i in range(workers)])
    if leaf == fmt or (leaf, fmt) == ("bf16", "fp32"):
        h, lf = fpisa.FORMATS[fmt].headroom, fpisa.FORMATS[leaf]
        bits = x.view(torch.int32 if leaf == "fp32" else torch.int16).reshape(workers, -1)
        bits[:, :5] = (h << lf.man_bits) | lf.man_mask
        bits[1:2, 4] = ((h + 1) << lf.man_bits) | lf.man_mask
    return x


def leaf_accum_parity(torch, dev, par):
    """K6's leaf mode against its plain version over SWEEP x LEAF_PAIRS x W
    in ACCUM_WORKERS and 3 (the kernel's loop over the workers) x both
    variants, with the non-finite words and the
    FPISA-A edges; then a ragged row (N = 1,000,003) and a base off the
    16-byte boundary (a view one element in), which take the
    one-element-a-thread edge kernel, in leaf and in local mode."""
    from repro_torch.core import fpisa
    from repro_torch.kernels import ops, ref

    for shape in SWEEP:
        for i, (fmt, leaf) in enumerate(LEAF_PAIRS):
            f = fpisa.FORMATS[fmt]
            for workers in ACCUM_WORKERS + (3,):
                x = leaf_accum_sample(torch, workers, shape, fmt, leaf,
                                      shape[0] + 13 * i + workers, dev)
                for variant in ("fpisa_a", "full"):
                    par.check("fpisa_accum", ops.accum_leaf(x, variant, fmt),
                              ref.accum_leaf_ref(x, variant, f),
                              f"leaf mode {fmt} from {leaf} {shape} W{workers} {variant}")
    for fmt, leaf in LEAF_PAIRS:
        f = fpisa.FORMATS[fmt]
        for workers in (1, 3, 4):
            x = leaf_accum_sample(torch, workers, (1_000_003,), fmt, leaf, 90 + workers, dev)
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
            buf[1:].copy_(x.reshape(-1))
            for what, xs in (("ragged", x), ("unaligned base", buf[1:].view(x.shape))):
                for variant in ("fpisa_a", "full"):
                    par.check("fpisa_accum", ops.accum_leaf(xs, variant, fmt),
                              ref.accum_leaf_ref(xs, variant, f),
                              f"leaf mode {fmt} from {leaf} {what} W{workers} {variant}")
                    if leaf == fmt:
                        x3 = xs.reshape(workers, 1, -1)
                        par.check("fpisa_accum", ops.accum(x3, variant, fmt),
                                  ref.accum_ref(x3, variant, f).to(torch.float32),
                                  f"local mode {fmt} {what} W{workers} {variant}")


def two_pass_accum_parity(torch, dev, par):
    """K3, K4, K5 and K6 (local and leaf mode) against their plain versions
    on the card."""
    from repro_torch.core import fpisa
    from repro_torch.kernels import ops, ref

    events = {"overwrite": 0, "overflow": 0}
    for shape in SWEEP:
        for fmt in FMTS:
            f = fpisa.FORMATS[fmt]
            x = sample(torch, shape, fmt, 7 * shape[0] + shape[1], dev)
            want = ref.extract_ref(x, f)
            for got, w, what in zip(ops.extract(x, fmt), want, ("exp", "man", "bmax")):
                par.check("fpisa_extract", got, w, f"{fmt} {shape} {what}")
            exp, man, bmax = want
            for preshift in (0, 2):
                gen = torch.Generator(device=dev).manual_seed(shape[0] + preshift)
                be = bmax + torch.randint(0, 40, bmax.shape, generator=gen, device=dev,
                                          dtype=torch.int32)
                par.check("fpisa_align", ops.align(exp, man, be, preshift),
                          ref.align_ref(exp, man, be, preshift), f"{fmt} {shape} p{preshift}")
                m = wire_sample(torch, shape, torch.int32, shape[1] + preshift, dev)
                be = torch.randint(0, f.exp_mask + 2, (shape[0],), generator=gen,
                                   device=dev, dtype=torch.int32)
                par.check("fpisa_decode", ops.decode(m, be, preshift, fmt),
                          ref.decode_ref(m, be, preshift, f), f"{fmt} {shape} p{preshift}")
            for workers in ACCUM_WORKERS + (3,):  # 3: the kernel's loop over the workers
                xs = accum_sample(torch, workers, shape, fmt, shape[0] + workers, dev)
                for variant in ("fpisa_a", "full"):
                    plain, st = fpisa.fpisa_sum_sequential(xs, f, variant, return_stats=True)
                    par.check("fpisa_accum", ops.accum(xs, variant, fmt),
                              plain.to(torch.float32), f"{fmt} {shape} W{workers} {variant}")
                    for k in events:
                        events[k] += int(st[k])
    if not (events["overwrite"] and events["overflow"]):
        raise AssertionError(f"the K6 inputs hit no FPISA-A overwrite/overflow: {events}")
    # the main path's largest leaf, the embedding gradient
    x = sample(torch, (EMBED_ROWS, 256), "fp32", 2, dev)
    exp, man, bmax = ops.extract(x, "fp32")
    for got, w, what in zip((exp, man, bmax), ref.extract_ref(x, fpisa.FP32),
                            ("exp", "man", "bmax")):
        par.check("fpisa_extract", got, w, f"embedding leaf {what}")
    aligned = ops.align(exp, man, bmax, 0)
    par.check("fpisa_align", aligned, ref.align_ref(exp, man, bmax, 0), "embedding leaf")
    par.check("fpisa_decode", ops.decode(aligned, bmax, 0, "fp32"),
              ref.decode_ref(aligned, bmax, 0, fpisa.FP32), "embedding leaf")
    del x, exp, man, bmax, aligned
    local = par.cases["fpisa_accum"]
    leaf_accum_parity(torch, dev, par)
    torch.cuda.synchronize()
    log(f"[parity] bit-equal to the plain versions: fpisa_extract "
        f"{par.cases['fpisa_extract']} cases, fpisa_align {par.cases['fpisa_align']}, "
        f"fpisa_decode {par.cases['fpisa_decode']}, fpisa_accum {par.cases['fpisa_accum']} "
        f"(local mode {local}: sweep x {FMTS}, W {ACCUM_WORKERS} and 3 x fpisa_a/full with "
        f"{events['overwrite']} overwrites and {events['overflow']} register overflows; leaf "
        f"mode {par.cases['fpisa_accum'] - local}: sweep x {LEAF_PAIRS} x W {ACCUM_WORKERS} "
        f"and 3 x "
        f"fpisa_a/full with the non-finite words and FPISA-A's edges, a ragged row and an "
        f"unaligned base at W 1/3/4, local mode there too; preshift 0/2, the embedding leaf)")


def train_main_path(torch, dev):
    """The main path, with the launch counts zeroed just before and read
    just after. Returns the launch counts, the model and its optimizer
    state."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.launch.train import train_loop

    cfg = get_config("qwen1.5-0.5b")
    zero_launches()
    t0 = time.perf_counter()
    model, opt_state, losses = train_loop(
        cfg, steps=STEPS, global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN,
        agg=AggConfig(strategy="fpisa", backend="auto"), device=dev, log_every=1)
    torch.cuda.synchronize()
    counts = read_launches()
    launches = k1k2_subset(counts)
    wall = time.perf_counter() - t0
    params = list(model.parameters())
    leaves = len(params)
    narrow = sum(p.dtype != torch.float32 for p in params)  # K2 casts these in registers
    log(f"[train] {STEPS} steps of {cfg.name} in {wall:.2f} s (init included), "
        f"world {dist.get_world_size()} ({dist.get_backend()}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(json.dumps({"launches_per_step": {k: v / STEPS for k, v in launches.items()},
                    "gradient_leaves": leaves,
                    "leaf_dtypes": sorted({str(p.dtype) for p in params})}))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    # per leaf and step: exponent mode, MAX, wire mode, SUM, K2 in the leaf's dtype
    check_fpisa_launches(counts, leaves * STEPS, "main path", leaf=narrow * STEPS)
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError("non-finite parameter after training")
    launches.update(check_a1_launches(counts, cfg, STEPS, "main"))
    launches.update(check_o1_launches(counts, STEPS, "main path", leaves))
    return launches, model, opt_state


def train_seq_path(torch, dev):
    """The fpisa_seq path, with K6's launch counts zeroed just before and
    read just after. Returns K6's counts (in all and by mode), the model and
    its optimizer state."""
    from repro_torch.configs import get_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.launch.train import train_loop

    cfg = get_config("qwen1.5-0.5b")
    zero_launches()
    t0 = time.perf_counter()
    model, opt_state, losses = train_loop(
        cfg, steps=STEPS, global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN,
        agg=AggConfig(strategy="fpisa_seq", backend="auto"), device=dev, log_every=1)
    torch.cuda.synchronize()
    counts = read_launches()
    launches = k6_subset(counts)
    leaves = len(list(model.parameters()))
    launches.update(check_o1_launches(counts, STEPS, "fpisa_seq path", leaves))
    log(f"[train] fpisa_seq: {STEPS} steps of {cfg.name} in {time.perf_counter() - t0:.2f} s "
        f"(init included); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(json.dumps({"fpisa_seq_launches_per_step": {k: v / STEPS for k, v in launches.items()},
                    "gradient_leaves": leaves}))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite fpisa_seq loss: {losses}")
    # one leaf-mode launch per gradient leaf per step, in the leaf's bf16
    check_seq_launches(launches, leaves * STEPS, "fpisa_seq path")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError("non-finite parameter after fpisa_seq training")
    return launches, model, opt_state


def training_batch(torch, dev, cfg, seq_len=SEQ_LEN, batch=GLOBAL_BATCH):
    """The batch ``train_loop`` would feed at step ``STEPS`` (seed 0), on
    the card: ``tokens`` of ``batch`` x seq_len and, for the
    encoder-decoder, its seeded ``frames``."""
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
    from repro_torch.launch.train import global_batch_at

    loader = ShardedLoader(SyntheticCorpus(cfg.vocab_size, 0), batch, seq_len)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in global_batch_at(cfg, loader, 0, STEPS).items()}


TRAIN_PHASES = ("train.forward_backward", "agg.allreduce_tree", "train.optimizer")


def phase_ms(torch, step, opt_state, batch, reps=5):
    """The program's own split of a training step (``train/step.py``'s
    phase spans, ``TRAIN_PHASES``): ``step`` once to warm up, then ``reps``
    steps on ``batch`` with the tracer on; the median of each phase span's
    device time (its CUDA events, first queued work to last), in ms, in
    ``TRAIN_PHASES``' order. The aggregation span waits for its output, as
    in every traced step. Each step gets ``opt_state`` itself (the moments
    move in place, the step count does not)."""
    from repro_torch import trace

    step(opt_state, batch)
    tr = trace.enable()
    try:
        for _ in range(reps):
            step(opt_state, batch)
        torch.cuda.synchronize()
    finally:
        trace.disable()
    spans = tr.spans
    return [statistics.median(1e3 * s["dev_dur"] for s in spans if s["name"] == name)
            for name in TRAIN_PHASES]


def step_breakdown(torch, dev, model, opt_state, strategy="fpisa", bucket_bytes=0,
                   seq_len=SEQ_LEN, batch_size=GLOBAL_BATCH):
    """Where a full-width training step's time goes, by phase: forward +
    backward, the aggregation of the gradient leaves (for fpisa K1's
    exponent mode, the MAX, K1's wire mode, the SUM and K2 in the leaf's
    dtype, with nothing eager between them; for fpisa_seq the all-gather,
    K6 and its casts; per leaf, or in buckets of ``bucket_bytes``, whose
    pack and unpack casts are eager), and the AdamW update: the program's
    train step and its phase spans (``phase_ms``) on the same batch
    (``training_batch``)."""
    from repro_torch.core.agg import AggConfig
    from repro_torch.optim import optimizers
    from repro_torch.train.step import make_train_step

    cfg = model.cfg
    batch = training_batch(torch, dev, cfg, seq_len, batch_size)
    opt_cfg = optimizers.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
    step = make_train_step(model, AggConfig(strategy=strategy, bucket_bytes=bucket_bytes),
                           opt_cfg, batch_size)
    parts = dict(zip(("forward+backward", "aggregation", "optimizer"),
                     phase_ms(torch, step, opt_state, batch)))
    total = sum(parts.values())
    what = f"{strategy}, buckets of {bucket_bytes} bytes" if bucket_bytes else strategy
    log(f"[breakdown] {what}: one step, " + ", ".join(
        f"{k} {v:.2f} ms ({100 * v / total:.1f}%)" for k, v in parts.items())
        + f"; sum {total:.2f} ms = {batch_size * seq_len / total * 1e3:,.0f} tok/s")
    return parts


def bucketed_path(torch, dev, model, tmpdir):
    """Bucketed, traced and autotuned aggregation (the fpisa path with
    ``bucket_bytes``), in the one-rank NCCL group:

    1. the replay profiler on the card (cuda backend) writes its spans to
       ``build/chip_smoke/autotune.jsonl``; the cost model is fitted from that
       file and ``auto_bucket_bytes`` picks a size for the model's 14 gradient
       leaves (when it picks per-leaf, 0, the best nonzero candidate is
       trained instead, and both are printed);
    2. 3 full-width training steps with that ``bucket_bytes``, K1 and K2's
       counts zeroed just before and read just after: each must launch once
       per bucket per step;
    3. on the trained gradients, per-leaf cuda aggregation must equal, bit
       for bit: bucketed cuda, per-leaf plain torch, chunked cuda
       (``chunk_elems`` = 2^20), hierarchical over a pair of one-rank groups
       (bucketed, stripes), and bucketed ``fpisa_seq`` must equal per-leaf
       ``fpisa_seq`` with K6's leaf mode once per bucket;
    4. the step's breakdown, bucketed against per-leaf, on CUDA events, and
       the traced encode / collective / finish sums of the bucketed
       aggregation. Returns the bucketed run's launch counts."""
    from repro_torch import trace
    from repro_torch.autotune import costmodel, profile, search
    from repro_torch.configs import get_config
    from repro_torch.core.agg import AggConfig, Aggregator
    from repro_torch.core.bucketer import make_plan
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime.elastic import make_groups

    shapes = [torch.empty(p.shape, dtype=p.dtype, device="meta") for p in model.parameters()]
    # 1. profile -> fit -> search
    t0 = time.perf_counter()
    spans = profile.profile_phases(
        AggConfig(strategy="fpisa", backend="cuda"), device=dev, iters=5, warmup=2,
        sizes=profile.probe_sizes(n_probes=9, max_elems=1 << 24))
    path = trace.write_jsonl(spans, tmpdir / "autotune.jsonl")
    fitted = costmodel.fit_from_jsonl(path)
    tuned = search.auto_bucket_bytes(trace_path=path, leaves=shapes)
    _, scores = search.choose_bucket_bytes(fitted, shapes, block=256)
    bucket_bytes = tuned or min((c for c in scores if c), key=lambda c: scores[c])
    log(f"[autotune] {len(spans)} probe spans in {time.perf_counter() - t0:.2f} s -> {path}")
    log(json.dumps({"autotune_fit": fitted.to_dict(),
                    "auto_bucket_bytes": tuned, "trained_bucket_bytes": bucket_bytes,
                    "predicted_ms": {str(c): v * 1e3 for c, v in scores.items()}}))
    plan = make_plan(shapes, block=256, bucket_bytes=bucket_bytes)
    buckets = len(plan.buckets)
    log(f"[bucketed] plan at {bucket_bytes} bytes: {buckets} buckets of "
        f"{min(b.elems for b in plan.buckets)}-{max(b.elems for b in plan.buckets)} "
        f"elements ({', '.join(sorted({b.group for b in plan.buckets}))}), passthrough "
        f"{list(plan.passthrough)}")

    # 2. training, counts zeroed just before and read just after
    cfg = get_config("qwen1.5-0.5b")
    agg = AggConfig(strategy="fpisa", backend="auto", bucket_bytes=bucket_bytes)
    zero_launches()
    t0 = time.perf_counter()
    trained, opt_state, losses = train_loop(
        cfg, steps=STEPS, global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN, agg=agg, device=dev,
        log_every=1)
    torch.cuda.synchronize()
    counts = read_launches()
    launches = k1k2_subset(counts)
    log(f"[bucketed] {STEPS} steps of {cfg.name} in {time.perf_counter() - t0:.2f} s "
        f"(init included); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(json.dumps({"bucketed_launches_per_step": {k: v / STEPS for k, v in launches.items()},
                    "buckets": buckets}))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite bucketed loss: {losses}")
    # one per bucket per step (a bucket is packed in the format's dtype), and
    # one per passthrough leaf, in its own dtype
    own = sum(shapes[i].dtype != torch.float32 for i in plan.passthrough)
    check_fpisa_launches(counts, (buckets + len(plan.passthrough)) * STEPS, "bucketed training",
                         leaf=own * STEPS)

    # 3. the aggregation forms on the trained gradients
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus

    tokens = ShardedLoader(SyntheticCorpus(cfg.vocab_size, 0), GLOBAL_BATCH,
                           SEQ_LEN).batch_at(STEPS)["tokens"]
    params = list(trained.parameters())
    grads = list(torch.autograd.grad(trained.loss({"tokens": torch.from_numpy(tokens).to(dev)}),
                                     params))

    def same(got, want, what):
        for i, (g, w) in enumerate(zip(got, want)):
            if not (g.dtype == w.dtype and torch.equal(g.view(torch.int16), w.view(torch.int16))
                    and torch.isfinite(g).all()):
                raise AssertionError(f"{what}: gradient leaf {i} differs from per-leaf")

    want = Aggregator(AggConfig(backend="cuda")).allreduce_tree(grads)
    zero_launches()
    same(Aggregator(AggConfig(backend="cuda", bucket_bytes=bucket_bytes)).allreduce_tree(grads),
         want, "bucketed cuda")
    check_fpisa_launches(read_launches(), buckets + len(plan.passthrough),
                         "bucketed cuda aggregation", leaf=own)
    same(Aggregator(AggConfig(backend="torch")).allreduce_tree(grads), want, "per-leaf plain")
    same(Aggregator(AggConfig(backend="cuda", chunk_elems=1 << 20)).allreduce_tree(grads),
         want, "chunked cuda")
    pair = make_groups(1)
    same(Aggregator(AggConfig(backend="cuda", bucket_bytes=bucket_bytes), pair)
         .allreduce_tree(grads), want, "hierarchical bucketed cuda")
    seq_want = Aggregator(AggConfig(strategy="fpisa_seq", backend="cuda")).allreduce_tree(grads)
    zero_launches()
    same(Aggregator(AggConfig(strategy="fpisa_seq", backend="cuda", bucket_bytes=bucket_bytes))
         .allreduce_tree(grads), seq_want, "bucketed fpisa_seq")
    # a bucket is packed in float32 (held to the reference's plan): leaf mode
    # at the fp32 format's own dtype, once per bucket
    check_seq_launches(read_launches(), buckets, "bucketed fpisa_seq")
    log(f"[check] full-width gradients ({len(grads)} leaves, {grads[0].dtype}): per-leaf cuda fpisa "
        f"bit-equal to bucketed cuda ({buckets} launches each of K1's exponent and wire modes "
        f"and K2), per-leaf plain, chunked cuda "
        f"(2^20), hierarchical bucketed cuda over a pair of one-rank groups; bucketed "
        f"fpisa_seq ({buckets} K6 launches) bit-equal to per-leaf fpisa_seq")
    del want, seq_want

    # 4. breakdown, bucketed vs per-leaf, then the traced phase sums
    parts = {bb: step_breakdown(torch, dev, trained, opt_state, "fpisa", bucket_bytes=bb)
             for bb in (0, bucket_bytes)}
    aggregator = Aggregator(agg)
    aggregator.allreduce_tree(grads)
    tr = trace.enable()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        aggregator.allreduce_tree(grads)
    torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t0) * 1e3 / reps
    trace.disable()
    sums = {ph: sum(s["dur"] for s in tr.spans if s["name"] == f"bucketer.{ph}") * 1e3 / reps
            for ph in ("encode", "collective", "finish")}
    log(f"[breakdown] bucketed aggregation, traced (each phase waited on): {traced_ms:.2f} ms "
        f"per tree on the host clock, of it encode {sums['encode']:.2f} ms, collective "
        f"{sums['collective']:.2f} ms, finish {sums['finish']:.2f} ms over {buckets} "
        f"buckets; in a traced step {parts[bucket_bytes]['aggregation']:.2f} ms on the card "
        f"(span events), per-leaf {parts[0]['aggregation']:.2f} ms")
    for bb in (0, bucket_bytes):
        aggregator = Aggregator(AggConfig(bucket_bytes=bb))
        diagnose(torch, lambda: aggregator.allreduce_tree(grads),
                 f"buckets of {bb} bytes" if bb else "per-leaf")
    return launches


def train_stacked(torch, dev, strategy):
    """3 full-width logical-worker steps (W = 4, all on this rank: k = 4,
    2 sequences each) through ``make_train_step(logical_workers=4)`` with
    ``strategy`` on the auto backend, the launch counts zeroed just before
    and read just after: for ``fpisa`` K1's exponent and wire modes (over
    the k workers' rows) and K2 in the leaf's dtype once per leaf per step,
    for ``fpisa_seq`` K6. Returns (launches, model, optimizer state,
    losses, peak GiB)."""
    from repro_torch.configs import get_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
    from repro_torch.models.registry import build
    from repro_torch.optim import optimizers
    from repro_torch.train.step import make_train_step

    cfg = get_config("qwen1.5-0.5b")
    model = build(cfg, device=dev, seed=0)
    opt_cfg = optimizers.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
    opt_state = optimizers.init(list(model.parameters()), opt_cfg)
    step = make_train_step(model, AggConfig(strategy=strategy, backend="auto"), opt_cfg,
                           GLOBAL_BATCH, logical_workers=LOGICAL_WORKERS)
    loader = ShardedLoader(SyntheticCorpus(cfg.vocab_size, 0), GLOBAL_BATCH, SEQ_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    losses = []
    for i in range(STEPS):
        tokens = torch.from_numpy(loader.batch_at(i)["tokens"]).to(dev)
        opt_state, metrics = step(opt_state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    counts = read_launches()
    launches = k1k2_subset(counts) if strategy == "fpisa" else k6_subset(counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = list(model.parameters())
    leaves = len(params)
    log(f"[stacked] {strategy}: {STEPS} steps of {cfg.name} with W = {LOGICAL_WORKERS} "
        f"logical workers on one rank (k = {LOGICAL_WORKERS}, "
        f"{GLOBAL_BATCH // LOGICAL_WORKERS} sequences each) in "
        f"{time.perf_counter() - t0:.2f} s; losses {losses}; peak memory {peak:.2f} GiB")
    log(json.dumps({f"stacked_{strategy}_launches_per_step":
                    {k: v / STEPS for k, v in launches.items()}, "gradient_leaves": leaves}))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite stacked {strategy} loss: {losses}")
    if strategy == "fpisa":
        check_fpisa_launches(counts, leaves * STEPS, "stacked fpisa",
                             leaf=sum(p.dtype != torch.float32 for p in params) * STEPS)
    else:
        check_seq_launches(counts, leaves * STEPS, f"stacked {strategy}")
    launches.update(check_o1_launches(counts, STEPS, f"stacked {strategy}", leaves))
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError(f"non-finite parameter after stacked {strategy} training")
    return launches, model, opt_state, losses, peak


def worker_grads(torch, dev, model):
    """The trained model's per-worker gradients on the next step's tokens,
    each worker's in its row of a (k, ...) stack."""
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus

    tokens = torch.from_numpy(ShardedLoader(SyntheticCorpus(model.cfg.vocab_size, 0),
                                            GLOBAL_BATCH, SEQ_LEN).batch_at(STEPS)["tokens"])
    params = list(model.parameters())
    stacks = [torch.empty((LOGICAL_WORKERS, *p.shape), dtype=p.dtype, device=dev)
              for p in params]
    for j, mb in enumerate(tokens.to(dev).reshape(LOGICAL_WORKERS, -1, SEQ_LEN)):
        for s, g in zip(stacks, torch.autograd.grad(model.loss({"tokens": mb}), params)):
            s[j].copy_(g)
    return stacks


def same_bits(torch, got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if not (g.dtype == w.dtype and g.shape == w.shape
                and torch.equal(g.view(torch.int16), w.view(torch.int16))
                and torch.isfinite(g).all()):
            raise AssertionError(f"{what}: gradient leaf {i} differs")


def stacked_breakdown(torch, dev, model, opt_state, strategy):
    """One logical-worker step by phase (``phase_ms``): the k forward+backward
    passes into the (k, ...) stacks, the stacked aggregation, the AdamW
    update."""
    from repro_torch.core.agg import AggConfig
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
    from repro_torch.optim import optimizers
    from repro_torch.train.step import make_train_step

    cfg = model.cfg
    tokens = torch.from_numpy(ShardedLoader(SyntheticCorpus(cfg.vocab_size, 0), GLOBAL_BATCH,
                                            SEQ_LEN).batch_at(STEPS)["tokens"]).to(dev)
    opt_cfg = optimizers.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
    step = make_train_step(model, AggConfig(strategy=strategy), opt_cfg, GLOBAL_BATCH,
                           logical_workers=LOGICAL_WORKERS)
    parts = dict(zip((f"{LOGICAL_WORKERS} x forward+backward", "stacked aggregation",
                      "optimizer"), phase_ms(torch, step, opt_state, {"tokens": tokens})))
    total = sum(parts.values())
    log(f"[breakdown] stacked {strategy}, W = {LOGICAL_WORKERS} on one rank: one step, "
        + ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f}%)" for k, v in parts.items())
        + f"; sum {total:.2f} ms = {GLOBAL_BATCH * SEQ_LEN / total * 1e3:,.0f} tok/s")
    return parts


def diagnose_passes(torch, dev, model):
    """A forward+backward of all the step's sequences against one of a
    logical worker's share, in the same state (CUDA events, median of 5),
    then ``diagnose`` of each: where the k passes of the stacked step spend
    their time."""
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus

    tokens = torch.from_numpy(ShardedLoader(SyntheticCorpus(model.cfg.vocab_size, 0),
                                            GLOBAL_BATCH, SEQ_LEN).batch_at(STEPS)["tokens"]).to(dev)
    params = list(model.parameters())
    share = GLOBAL_BATCH // LOGICAL_WORKERS
    runs = {n: (lambda t=tokens[:n]: torch.autograd.grad(model.loss({"tokens": t}), params))
            for n in (GLOBAL_BATCH, share)}
    times = {n: median_ms(torch, fn, reps=5, warmup=1) for n, fn in runs.items()}
    log(f"[diagnose] forward+backward, same weights: {GLOBAL_BATCH} sequences "
        f"{times[GLOBAL_BATCH]:.2f} ms, {share} sequences {times[share]:.2f} ms "
        f"({LOGICAL_WORKERS} x = {LOGICAL_WORKERS * times[share]:.2f} ms)")
    for n, fn in runs.items():
        diagnose(torch, fn, f"forward+backward of {n} sequences")


def determinism(torch, dev, model):
    """Which ops of the full-width backward repeat their bits on the card,
    with and without ``runtime.elastic.reproducible`` (deterministic
    algorithms): the whole backward run 3 more times against a first run
    (the leaves that differ), each candidate op alone, and what the
    deterministic mode costs a forward+backward (CUDA events)."""
    import torch.nn.functional as F

    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
    from repro_torch.runtime.elastic import reproducible

    tokens = torch.from_numpy(ShardedLoader(SyntheticCorpus(model.cfg.vocab_size, 0),
                                            GLOBAL_BATCH, SEQ_LEN).batch_at(0)["tokens"]).to(dev)
    names, params = zip(*model.named_parameters())

    def grads():
        return [g.clone() for g in torch.autograd.grad(model.loss({"tokens": tokens}), params)]

    def differing(runs):
        return sorted({n for r in runs[1:] for n, a, b in zip(names, runs[0], r)
                       if not torch.equal(a.view(torch.int16), b.view(torch.int16))})

    gen = torch.Generator(device=dev).manual_seed(5)
    d, v = model.cfg.d_model, model.cfg.vocab_size
    tok, wq = model.embed["tok"], model.layers["attn"]["wq"]
    x = torch.randn(GLOBAL_BATCH, SEQ_LEN, d, generator=gen, device=dev).to(
        tok.dtype).requires_grad_()
    up = torch.randn(GLOBAL_BATCH, SEQ_LEN, d, generator=gen, device=dev).to(tok.dtype)
    up_v = torch.randn(GLOBAL_BATCH, SEQ_LEN, v, generator=gen, device=dev).to(tok.dtype)
    logits = torch.randn(GLOBAL_BATCH, SEQ_LEN - 1, v, generator=gen,
                         device=dev).requires_grad_()
    ops_alone = {
        "embedding backward (F.embedding)":
            (lambda: (F.embedding(tokens, tok) * up).float().sum(), [tok]),
        "tied head matmul backward (x @ tok.T)":
            (lambda: ((x @ tok.T) * up_v).float().sum(), [x, tok]),
        "q projection matmul backward":
            (lambda: ((x @ wq[0].reshape(d, -1)) * up).float().sum(), [x, wq]),
        "log_softmax + gather backward (float32 logits)":
            (lambda: -(torch.log_softmax(logits, -1)
                       .gather(-1, tokens[:, 1:, None].long())).mean(), [logits]),
    }

    def alone(fn, inputs):
        runs = [[g.clone() for g in torch.autograd.grad(fn(), inputs)] for _ in range(4)]
        return any(not torch.equal(a.view(torch.int16), b.view(torch.int16))
                   for r in runs[1:] for a, b in zip(runs[0], r))

    def mode(name):
        return reproducible(dev) if name == "reproducible" else contextlib.nullcontext()

    report = {}
    for name in ("default", "reproducible"):
        with mode(name):
            report[name] = {
                "backward_leaves_differing": differing([grads() for _ in range(4)]),
                "ops_differing": [k for k, (fn, inp) in ops_alone.items() if alone(fn, inp)],
                "forward_backward_ms": []}
    for name in ("default", "reproducible") * 2:  # in turns: drift shows
        with mode(name):
            report[name]["forward_backward_ms"].append(median_ms(
                torch, lambda: torch.autograd.grad(model.loss({"tokens": tokens}), params),
                reps=5, warmup=1))
    log("[determinism] " + json.dumps(report))
    if report["reproducible"]["backward_leaves_differing"]:
        raise AssertionError("the backward does not repeat its bits under "
                             f"reproducible(): {report['reproducible']}")
    return report


def checkpoint_resume(torch, dev, tmpdir):
    """Checkpointed resume at full width through ``train_loop(ckpt_dir=)``
    (flat fpisa): 2 steps with a bundle after step 1, a resume that runs
    step 2, and an uninterrupted 3-step run, all in the default mode
    (``train_loop`` does not turn on deterministic algorithms). The resumed
    step's loss and every parameter and moment must equal the
    uninterrupted run's bits.
    Then one bundle is saved and restored on its own, timed, and the
    directory removed."""
    from repro_torch.configs import get_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime import checkpoint as ckpt

    cfg = get_config("qwen1.5-0.5b")
    d = tmpdir / "ckpt"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    # bf16 params + fp32 m and v: 2 + 4 + 4 bytes per parameter, two bundles at most
    need = 2 * 10 * 463_987_712 + (1 << 30)
    free = shutil.disk_usage(d).free
    if free < need:
        raise AssertionError(f"checkpoint phase: {free / 1e9:.1f} GB free under {d}, needs "
                             f"{need / 1e9:.1f} GB for two full-width bundles")
    kw = dict(steps=3, global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN, device=dev, log_every=1,
              agg=AggConfig(strategy="fpisa", backend="auto"))
    try:
        t0 = time.perf_counter()
        train_loop(cfg, **{**kw, "steps": 2}, ckpt_dir=str(d), ckpt_every=1)
        first = time.perf_counter() - t0
        if ckpt.latest_step(str(d)) != 1:
            raise AssertionError(f"expected a bundle at step 1, found "
                                 f"{ckpt.committed_steps(str(d))}")
        t0 = time.perf_counter()
        resumed, opt_r, hist_r = train_loop(cfg, **kw, ckpt_dir=str(d), ckpt_every=1)
        second = time.perf_counter() - t0
        whole, opt_w, hist_w = train_loop(cfg, **kw)
        if len(hist_r) != 1 or hist_r[0] != hist_w[2]:
            raise AssertionError(f"resumed step-2 loss {hist_r} != uninterrupted {hist_w}")
        for what, a, b in (("parameter", list(resumed.parameters()), list(whole.parameters())),
                           ("moment", opt_r.m + opt_r.v, opt_w.m + opt_w.v)):
            for i, (x, y) in enumerate(zip(a, b)):
                if not torch.equal(x.view(torch.int16), y.view(torch.int16)):
                    raise AssertionError(f"resumed {what} {i} differs from the uninterrupted run")
        del whole, opt_w
        log(f"[ckpt] resumed step-2 loss {hist_r[0]!r} bit-equal to the uninterrupted run's "
            f"{hist_w[2]!r} ({hist_w}); all {len(list(resumed.parameters()))} parameters and "
            f"{len(opt_r.m + opt_r.v)} moments bit-equal; run to step 1 with its bundle "
            f"{first:.2f} s, resume to step 2 {second:.2f} s (init included)")
        shutil.rmtree(d)
        d.mkdir()
        trees = ckpt.state_trees(resumed, opt_r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_bundle(str(d), 3, trees)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
        t0 = time.perf_counter()
        restored, _ = ckpt.restore_bundle(str(d), 3, trees)
        opt_back = ckpt.load_state(resumed, opt_r, restored)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if opt_back.step != 3:
            raise AssertionError(f"restored optimizer step {opt_back.step}, expected 3")
        log(f"[ckpt] one full-width bundle: {size} bytes ({size / 1e9:.3f} GB: bf16 params, "
            f"fp32 m and v), save_bundle {save_s:.2f} s ({size / save_s / 1e9:.2f} GB/s), "
            f"restore_bundle + load_state {restore_s:.2f} s ({size / restore_s / 1e9:.2f} GB/s), "
            f"{free / 1e9:.1f} GB were free")
        return {"bundle_bytes": size, "save_s": save_s, "restore_s": restore_s}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def stacked_timing(torch, dev, leaf_sizes):
    """K1, K2 and K6 at the stacked step's shapes: K1's exponent and wire
    modes once per leaf over the k = 4 workers' (4, R, 256) bf16 stack (the
    wire mode folding the workers), K2 once per leaf from the folded (R,
    256) plane into bf16, K6 once per leaf over the (4, 1, N) stack; CUDA
    events against the bound, as in ``timing``."""
    from repro_torch.core import fpisa
    from repro_torch.core.allreduce import _wire_shift
    from repro_torch.kernels import ops, ref

    fmt = fpisa.FP32
    k = LOGICAL_WORKERS
    shift = _wire_shift(fmt, k, 32)
    workers = [step_leaves(torch, dev, leaf_sizes, seed=100 * j) for j in range(k)]
    xs = [torch.stack(per_leaf).to(torch.bfloat16) for per_leaf in zip(*workers)]
    del workers
    rows = sum(x.shape[1] for x in xs)  # of one worker
    elems = rows * 256
    what = f"stacked step, k = {k}: {len(xs)} leaves, {k} x {rows} rows x 256 bf16"
    bmaxs = [ops.block_max(x, "fp32") for x in xs]
    modes = {}
    for mode, kernel, plain, per_elem, ops_per_elem in (
            ("exponent", lambda: [ops.block_max(x, "fp32") for x in xs],
             lambda: [ref.block_max_ref(x, fmt) for x in xs], 2 * k, k * OPS_PER_ELEM["block_max"]),
            ("wire", lambda: [ops.encode_wire(x, b, shift, 32, "fp32") for x, b in zip(xs, bmaxs)],
             lambda: [ref.encode_wire_ref(x, b, shift, 32, fmt) for x, b in zip(xs, bmaxs)],
             2 * k + 4, k * OPS_PER_ELEM["encode_wire"])):
        bytes_ = elems * per_elem + rows * 4
        modes[mode] = time_kernel(torch, "fused_encode_align", kernel, plain, bytes_,
                                  elems * ops_per_elem, copy_ms(torch, dev, [bytes_]),
                                  f"{mode} mode, {what}", plain_reps=3)
    pair_bytes = elems * (4 * k + 4) + rows * 8
    out = {"fused_encode_align": time_kernel(
        torch, "fused_encode_align",
        lambda: [ops.encode_wire(x, ops.block_max(x, "fp32"), shift, 32, "fp32") for x in xs],
        lambda: [ref.encode_wire_ref(x, ref.block_max_ref(x, fmt), shift, 32, fmt) for x in xs],
        pair_bytes, elems * k * (OPS_PER_ELEM["block_max"] + OPS_PER_ELEM["encode_wire"]),
        copy_ms(torch, dev, [pair_bytes]), f"exponent + wire mode, {what}", plain_reps=3)}
    out["fused_encode_align"]["ms_by_mode"] = modes
    out["passes"] = stacked_passes(torch, xs, shift)
    planes = [ops.encode_wire(x, b, shift, 32, "fp32") for x, b in zip(xs, bmaxs)]
    del xs
    out["fused_decode"] = time_kernel(
        torch, "fused_decode",
        lambda: [ops.decode_fused(m, b, shift, "fp32", torch.bfloat16) for m, b in zip(planes, bmaxs)],
        lambda: [ref.fused_decode_ref(m, b, shift, fmt, torch.bfloat16)
                 for m, b in zip(planes, bmaxs)],
        elems * 6 + rows * 4, elems * OPS_PER_ELEM["decode_leaf"],
        copy_ms(torch, dev, [elems * 6 + rows * 4]),
        f"stacked step: {len(planes)} leaves, {rows} rows x 256 (the folded plane) into bf16")
    del planes
    out["fpisa_accum"] = accum_stacked_timing(torch, dev, leaf_sizes)
    return out


def accum_stacked_timing(torch, dev, leaf_sizes):
    """K6 at the stacked fpisa_seq step's shape, once per leaf over the (4,
    N) stack of the k = 4 workers' leaves: local mode at fp32, then leaf
    mode at bf16 (the stacked fpisa_seq path's) beside the composition it
    replaced (``leaf_mode_timing``); CUDA events against the bound, as in
    ``timing``. Returns leaf mode's times with ``ms_by_mode``."""
    from repro_torch.core import fpisa
    from repro_torch.kernels import ops, ref

    k = LOGICAL_WORKERS
    workers = [step_leaves(torch, dev, leaf_sizes, seed=100 * j) for j in range(k)]
    stacks = [torch.stack(per_leaf).reshape(k, 1, -1) for per_leaf in zip(*workers)]
    del workers
    n = sum(s.shape[-1] for s in stacks)
    what = f"stacked fpisa_seq step, W = {k} over {len(stacks)} leaves, {n} elements"
    local = time_kernel(
        torch, "fpisa_accum", lambda: [ops.accum(s, "fpisa_a", "fp32") for s in stacks],
        lambda: [ref.accum_ref(s, "fpisa_a", fpisa.FP32) for s in stacks],
        n * (k + 1) * 4, n * accum_ops_per_elem(k),
        copy_ms(torch, dev, [s.numel() // k * (k + 1) * 4 for s in stacks]),
        f"local mode, {what} of fp32", plain_reps=3)
    bf16 = [s.reshape(k, -1).to(torch.bfloat16) for s in stacks]
    del stacks
    out = leaf_mode_timing(torch, dev, bf16, f"{what} of bf16, fp32 format")
    out["ms_by_mode"] = {"local": local, "leaf": dict(out)}
    return out


def stacked_passes(torch, xs, shift):
    """One stacked step's aggregation passes over the (k, R, 256) bf16
    stacks ``xs`` with the collectives left out, host issue against CUDA
    events, in turns: the eager-glue composition the cuda backend ran
    before the modes (the staging cast, the local mode over the k R rows,
    the worker max, the residual shift, the int32 fold, K2 in fp32, the
    cast back: about 122 bytes an output element at k = 4) against the
    modes' (26)."""
    from repro_torch.core import fpisa
    from repro_torch.core import numerics as nx
    from repro_torch.kernels import ops

    def glue():
        for x in xs:
            k = x.shape[0]
            man, local = ops.encode_align(fpisa.to_packed(x, "fp32").reshape(-1, 256), "fp32")
            local = local.reshape(k, -1)
            bmax = local.amax(0).clone()
            man = nx.arshift(man.reshape(k, -1, 256), (bmax[None, :] - local)[:, :, None] + shift)
            total = man.reshape(k, -1).sum(0, dtype=torch.int32)
            ops.decode_fused(total.reshape(-1, 256), bmax, shift, "fp32").to(torch.bfloat16)

    def modes():
        for x in xs:
            b = ops.block_max(x, "fp32")
            ops.decode_fused(ops.encode_wire(x, b, shift, 32, "fp32"), b, shift, "fp32",
                             torch.bfloat16)

    passes = {}
    for name, fn in (("glue", glue), ("modes", modes), ("glue", glue), ("modes", modes)):
        fn()
        torch.cuda.synchronize()
        passes.setdefault(name, []).append(issue_vs_device(torch, fn))
        torch.cuda.empty_cache()
    elems = sum(x[0].numel() for x in xs)
    log(f"[time] one stacked step's aggregation passes without the collectives, k = "
        f"{xs[0].shape[0]}, {len(xs)} leaves of bf16: eager-glue composition (floor at 122 B an "
        f"element {elems * 122 / HBM_BYTES_PER_S * 1e3:.4f} ms) host issue / CUDA events "
        + ", ".join(f"{i:.3f} / {d:.3f}" for i, d in passes["glue"])
        + f" ms; the modes (26 B an element, floor {elems * 26 / HBM_BYTES_PER_S * 1e3:.4f} ms) "
        + ", ".join(f"{i:.3f} / {d:.3f}" for i, d in passes["modes"]) + f" ms; {CARD}")
    return passes


def stacked_path(torch, dev, tmpdir, leaf_sizes):
    """The fourth slice's path, in the one-rank NCCL group: logical-worker
    training with stacked fpisa (K1/K2 once per leaf per step over the
    k workers' rows) and stacked fpisa_seq (K6 at W = 4), each with cuda ==
    plain bits on the trained per-worker gradients; bucketed stacked ==
    per-leaf stacked; the step's breakdown; the card's determinism with and
    without deterministic algorithms; checkpointed resume at full width;
    and the kernels at the stacked shapes. Returns ({path: launches},
    times)."""
    from repro_torch.core.agg import AggConfig, Aggregator
    from repro_torch.core.bucketer import make_plan

    launches, model, opt_state, _, _ = train_stacked(torch, dev, "fpisa")
    stacks = worker_grads(torch, dev, model)
    want = Aggregator(AggConfig(backend="cuda"), stacked=True).allreduce_tree(stacks)
    same_bits(torch, Aggregator(AggConfig(backend="torch"), stacked=True)
              .allreduce_tree(stacks), want, "stacked fpisa, plain vs cuda")
    bucket_bytes = 32 << 20
    buckets = len(make_plan([torch.empty(p.shape, dtype=p.dtype, device="meta")
                             for p in model.parameters()], block=256,
                            bucket_bytes=bucket_bytes).buckets)
    zero_launches()
    same_bits(torch, Aggregator(AggConfig(backend="cuda", bucket_bytes=bucket_bytes),
                                stacked=True).allreduce_tree(stacks), want,
              "bucketed stacked fpisa vs per-leaf stacked")
    check_fpisa_launches(read_launches(), buckets, "bucketed stacked fpisa", leaf=0)
    log(f"[check] stacked fpisa, full-width per-worker gradients ({len(stacks)} leaves x "
        f"k = {LOGICAL_WORKERS}): cuda bit-equal to plain; bucketed at {bucket_bytes} bytes "
        f"({buckets} buckets, {buckets} launches each of K1's exponent and wire modes and K2) "
        f"bit-equal to per-leaf stacked")
    stacked_agg = Aggregator(AggConfig(), stacked=True)
    diagnose(torch, lambda: stacked_agg.allreduce_tree(stacks),
             f"stacked aggregation, k = {LOGICAL_WORKERS} ({CARD})")
    aggregation_kernels(torch, lambda: stacked_agg.allreduce_tree(stacks),
                        f"stacked aggregation, k = {LOGICAL_WORKERS}")
    del stacks, want
    stacked_breakdown(torch, dev, model, opt_state, "fpisa")
    diagnose_passes(torch, dev, model)
    determinism(torch, dev, model)
    del model, opt_state
    torch.cuda.empty_cache()

    seq_launches, model, opt_state, _, _ = train_stacked(torch, dev, "fpisa_seq")
    stacks = worker_grads(torch, dev, model)
    same_bits(torch, Aggregator(AggConfig(strategy="fpisa_seq", backend="torch"), stacked=True)
              .allreduce_tree(stacks),
              Aggregator(AggConfig(strategy="fpisa_seq", backend="cuda"), stacked=True)
              .allreduce_tree(stacks), "stacked fpisa_seq, plain vs cuda")
    log(f"[check] stacked fpisa_seq (K6 at W = {LOGICAL_WORKERS}), full-width per-worker "
        f"gradients: cuda bit-equal to plain")
    del stacks
    stacked_breakdown(torch, dev, model, opt_state, "fpisa_seq")
    del model, opt_state
    torch.cuda.empty_cache()

    checkpoint_resume(torch, dev, tmpdir)
    torch.cuda.empty_cache()
    times = stacked_timing(torch, dev, leaf_sizes)
    launches = {"stacked_fpisa": launches, "stacked_fpisa_seq": seq_launches}
    log(json.dumps({"stacked_launches": launches, "stacked_times": times}))
    return launches, times


def fig9_batches(torch, dev, vocab):
    """The ``[fig9]`` batches, the same for both runs: step i's 8 x 512
    tokens from ``np.random.default_rng(1000 + i)``, with the reference
    gate's 8-token motif (``default_rng(5)``) at positions 0-8 and 16-24 of
    every 32."""
    import numpy as np

    motif = np.random.default_rng(5).integers(0, vocab, 8)
    out = []
    for step in range(FIG9_STEPS):
        toks = np.random.default_rng(1000 + step).integers(0, vocab, (GLOBAL_BATCH, SEQ_LEN))
        for b in range(0, SEQ_LEN, 32):
            toks[:, b:b + 8] = motif
            toks[:, b + 16:b + 24] = motif
        out.append(torch.from_numpy(toks).to(dev))
    return out


def fig9_run(torch, dev, strategy, batches):
    """``FIG9_STEPS`` logical-worker steps (W = 4 on this rank, 2 sequences
    each) of full-width qwen1.5-0.5b from seed 0 with ``strategy``, every
    kernel's count zeroed just before and read just after. Returns (losses,
    launches, model, step, wall s, per-step CUDA-event ms, peak GiB)."""
    from repro_torch.configs import get_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.models.registry import build
    from repro_torch.optim import optimizers
    from repro_torch.train import step as train_step

    cfg = get_config("qwen1.5-0.5b")
    model = build(cfg, device=dev, seed=0)
    opt_cfg = optimizers.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate,
                                   warmup_steps=FIG9_WARMUP)
    opt_state = optimizers.init(list(model.parameters()), opt_cfg)
    agg = AggConfig(strategy=strategy, backend="auto")
    if strategy == "native":
        # make_train_step refuses native with logical workers (the reference's
        # rule: native has no explicit boundary); the same logical-worker step
        # with the stacked native strategy is the float sum of the same four
        # workers' gradients, the scale of the FPISA-A sum
        step = train_step._logical_worker_step(model, agg, opt_cfg, None, LOGICAL_WORKERS)
    else:
        step = train_step.make_train_step(model, agg, opt_cfg, GLOBAL_BATCH,
                                          logical_workers=LOGICAL_WORKERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    losses, ms = [], []
    t0 = time.perf_counter()
    for tokens in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        opt_state, metrics = step(opt_state, {"tokens": tokens})
        end.record()
        losses.append(float(metrics["loss"]))
        ms.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    return (losses, launches, model, lambda: step(opt_state, {"tokens": batches[-1]}), wall,
            ms, torch.cuda.max_memory_allocated() / 2**30)


def k6_step_share(torch, run):
    """K6's device ms in one ``run()`` (torch.profiler, kernels named
    ``accum_kernel``) and all kernels' device ms, or None when the profiler
    records no device time."""
    from torch.autograd import DeviceType

    events = [e for e in profiled_events(torch, run) or [] if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0) for e in events) / 1e3
    k6 = sum(getattr(e, "self_device_time_total", 0) for e in events
             if "accum_kernel" in e.key) / 1e3
    return (k6, busy) if busy else None


def fig9_gap(a, b):
    """(mean relative gap of curve ``b`` from ``a`` over the last 10 steps,
    the largest gap): the reference gate's measure."""
    diffs = [abs(x - y) / max(abs(x), 1e-6) for x, y in zip(a, b)]
    return statistics.mean(diffs[-10:]), max(diffs)


def fig9_path(torch, dev):
    """The paper's Fig. 9 gate at full width (tests/test_torch_convergence.py
    at smoke size): qwen1.5-0.5b trained ``FIG9_STEPS`` steps of 8 x 512
    through the logical-worker step (W = 4, 2 sequences each) with the
    config's AdamW (lr 3e-4) and the gate's ``FIG9_WARMUP`` warm-up steps,
    once with the exact float sum of the four workers' gradients
    (``native``) and once with their switch-arrival FPISA-A sum
    (``fpisa_seq``: K6 at W = 4), both from seed 0 on the same batches
    (``fig9_batches``); then ``native`` once more, whose gap from the first
    is the card's own run-to-run spread (the backward's float order).
    Fails unless both curves learn (last loss < 0.9 x the first), the mean
    relative gap over the last 10 steps is under 0.05 (the reference's
    bounds), K6's leaf mode launched once per leaf per step in the ``fpisa_seq`` run and
    never in the ``native`` one, and A1 launched as the four workers'
    remat'd passes need, every launch on the bf16 tensor-core kernels
    (``check_a1_routes`` over the returned paths). Prints the curves, each
    run's wall time, per-step median (CUDA events), peak memory and K6's
    share of a ``fpisa_seq`` step. Returns {path: launches}."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen1.5-0.5b")
    batches = fig9_batches(torch, dev, cfg.vocab_size)
    curves, paths = [], {}
    for strategy in ("native", "fpisa_seq", "native"):
        losses, launches, model, one_step, wall, ms, peak = fig9_run(torch, dev, strategy,
                                                                     batches)
        leaves = len(list(model.parameters()))
        curves.append(losses)
        paths.setdefault(f"fig9_{strategy}", launches)
        check_seq_launches(launches, leaves * FIG9_STEPS if strategy == "fpisa_seq" else 0,
                           f"[fig9] {strategy}")
        want_a1 = {"chunked_attention_fwd": 2 * cfg.num_layers * LOGICAL_WORKERS * FIG9_STEPS,
                   "chunked_attention_bwd": cfg.num_layers * LOGICAL_WORKERS * FIG9_STEPS}
        got_a1 = {k: launches[k] for k in A1}
        if got_a1 != want_a1:
            raise AssertionError(f"[fig9] {strategy}: A1 launched {got_a1}, expected {want_a1}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"[fig9] {strategy}: non-finite loss {losses}")
        share = ""
        if strategy == "fpisa_seq":
            one_step()  # warm: the profiled step below is a steady one
            prof = k6_step_share(torch, one_step)
            share = (f"; K6 {prof[0]:.3f} ms of {prof[1]:.2f} ms of kernels in a profiled "
                     f"step, {100 * prof[0] / statistics.median(ms):.2f} % of the median step"
                     if prof else "; K6's share not measured (no device time in the profile)")
        log(f"[fig9] {strategy}{' again' if len(curves) == 3 else ''}: {FIG9_STEPS} steps of "
            f"{cfg.name} (W = {LOGICAL_WORKERS} logical workers, "
            f"{GLOBAL_BATCH // LOGICAL_WORKERS} x {SEQ_LEN} each) in {wall:.2f} s; step median "
            f"{statistics.median(ms):.2f} ms (CUDA events, {min(ms):.2f}-{max(ms):.2f}); peak "
            f"memory {peak:.2f} GiB; K6 launches {launches['fpisa_accum']} ({leaves} "
            f"leaves){share}; {CARD}")
        log(f"[fig9] {strategy} losses {json.dumps(losses)}")
        del model, one_step
        torch.cuda.empty_cache()
    exact, fpisa, again = curves
    gap, largest = fig9_gap(exact, fpisa)
    floor, floor_largest = fig9_gap(exact, again)
    log(f"[fig9] first -> last loss: native {exact[0]:.4f} -> {exact[-1]:.4f}, fpisa_seq "
        f"{fpisa[0]:.4f} -> {fpisa[-1]:.4f}; mean relative gap over the last 10 steps "
        f"{gap:.3e} (bound 0.05), largest {largest:.3e}; native against itself "
        f"{floor:.3e}, largest {floor_largest:.3e}; {CARD}")
    for name, curve in (("native", exact), ("fpisa_seq", fpisa)):
        if not curve[-1] < 0.9 * curve[0]:
            raise AssertionError(f"[fig9] {name} did not learn: {curve}")
    if not gap < 0.05:
        raise AssertionError(f"[fig9] the curves part: gap {gap} (native {exact[-5:]}, "
                             f"fpisa_seq {fpisa[-5:]})")
    return paths


def wrapper(name):
    """The launch function that counts kernel ``name``'s launches: A1's in
    ``kernels/attention.py``, S1's in ``kernels/ssd.py``, O1's in
    ``kernels/adamw.py``, K1-K6's in ``kernels/ops.py`` (K1's local mode;
    ``k1_mode_wrappers`` has all three)."""
    from repro_torch.kernels import adamw, attention, ops, ssd

    module = attention if name in A1 else ssd if name in S1 else adamw if name in O1 else ops
    return getattr(module, KERNEL_WRAPPER[name])


def k1_mode_wrappers():
    from repro_torch.kernels import ops

    return {mode: getattr(ops, fn) for mode, fn in K1_MODES.items()}


def zero_launches():
    for name in KERNELS:
        wrapper(name).launches = 0
    for fn in k1_mode_wrappers().values():
        fn.launches = 0
    wrapper("fused_decode").modes = dict.fromkeys(K2_MODES, 0)
    wrapper("fpisa_accum").launches_by_mode = dict.fromkeys(K6_MODES, 0)
    for name in A1:
        wrapper(name).routes = dict.fromkeys(wrapper(name).routes, 0)


def read_launches():
    """Every kernel's count (K1's summed over its three modes), K1's, K2's
    and K6's per mode as ``name@mode``, and A1's per route as
    ``name@route`` (``wgmma``: the bf16 tensor-core kernels;
    ``cuda_cores``: the float32 ones)."""
    counts = {name: wrapper(name).launches for name in KERNELS}
    k1 = {mode: fn.launches for mode, fn in k1_mode_wrappers().items()}
    counts["fused_encode_align"] = sum(k1.values())
    counts.update({f"fused_encode_align@{mode}": n for mode, n in k1.items()})
    counts.update({f"fused_decode@{mode}": n for mode, n in wrapper("fused_decode").modes.items()})
    counts.update({f"fpisa_accum@{mode}": n
                   for mode, n in wrapper("fpisa_accum").launches_by_mode.items()})
    counts.update({f"{name}@{route}": n
                   for name in A1 for route, n in wrapper(name).routes.items()})
    return counts


def k1k2_subset(counts):
    """K1's and K2's counts, in all and by mode, out of ``read_launches()``'s."""
    return {k: v for k, v in counts.items() if k.split("@")[0] in K1K2}


def check_fpisa_launches(counts, n, what, leaf=None):
    """An ``fpisa`` path's K1 and K2 counts (``read_launches()``) for ``n``
    aggregated tensors (leaves x steps, buckets, telemetry flushes): K1's
    exponent and wire modes n launches each, its local mode none (no residual
    shift, wire cast or fold runs outside the kernels), K2 n. ``leaf``: how
    many of K2's wrote the leaf's dtype (the rest the format's)."""
    got = {f"K1 {m}": counts[f"fused_encode_align@{m}"] for m in K1_MODES}
    got["K2"] = counts["fused_decode"]
    want = {"K1 local": 0, "K1 exponent": n, "K1 wire": n, "K2": n}
    if leaf is not None:
        got["K2 leaf"], want["K2 leaf"] = counts["fused_decode@leaf"], leaf
    if got != want:
        raise AssertionError(f"{what}: K1/K2 launches {got}, expected {want}")


def k6_subset(counts):
    """K6's counts, in all and by mode, out of ``read_launches()``'s."""
    return {k: v for k, v in counts.items() if k.split("@")[0] == "fpisa_accum"}


def check_seq_launches(counts, n, what):
    """An ``fpisa_seq`` path's K6 counts (``read_launches()``) for ``n``
    aggregated tensors (leaves x steps, buckets, telemetry flushes): leaf
    mode n launches, local mode none (no upcast, staging cast or downcast
    runs around K6 for a leaf the format widens)."""
    got = {m: counts[f"fpisa_accum@{m}"] for m in K6_MODES}
    want = {"local": 0, "leaf": n}
    if got != want:
        raise AssertionError(f"{what}: K6 launches by mode {got}, expected {want}")


def a1_subset(counts):
    """A1's counts and its per-route counts out of ``read_launches()``'s."""
    return {k: v for k, v in counts.items() if k.split("@")[0] in A1}


def s1_subset(counts):
    """S1's counts out of ``read_launches()``'s."""
    return {k: counts[k] for k in S1}


def check_s1_launches(counts, cfg, steps, what):
    """S1's launches over ``steps`` training steps of ``cfg``: in a model
    of Mamba2 blocks (families "ssm", "hybrid", "zamba2": every layer is one) the
    forward once per layer per step and once more in the layer's recompute
    (remat other than "none"), the backward once per layer per step; in any
    other model none."""
    layers = cfg.num_layers if cfg.family in ("ssm", "hybrid", "zamba2") else 0
    want = {"ssd_forward": (1 + (cfg.remat != "none")) * layers * steps,
            "ssd_backward": layers * steps}
    if s1_subset(counts) != want:
        raise AssertionError(f"{what}: S1 launched {s1_subset(counts)}, expected {want}")


def o1_subset(counts):
    """O1's counts out of ``read_launches()``'s."""
    return {k: counts[k] for k in O1}


def check_o1_launches(counts, steps, what, leaves):
    """O1's launches over ``steps`` AdamW steps of a tree of ``leaves``
    leaves: its norm and its update kernel once a step for each
    ``MAX_LEAVES`` of them. Returns O1's counts."""
    from repro_torch.kernels.adamw import MAX_LEAVES

    n = -(-leaves // MAX_LEAVES) * steps
    want = dict.fromkeys(O1, n)
    if o1_subset(counts) != want:
        raise AssertionError(f"{what}: O1 launched {o1_subset(counts)}, expected {want}")
    return o1_subset(counts)


def check_paged_equals_dense(torch, dev, model, tag="[serve] check (a)"):
    """Check (a): one ``decode_step_paged`` equals ``decode_step`` bit for
    bit at B = 16 with MP x page == max_len, on caches holding the same
    prefill (the dense cache's rows copied into each slot's pages); the
    k/v both write equal too."""
    from repro_torch.serve.kvcache import PagedKVCache

    cfg, b, plen = model.cfg, SERVE_SLOTS, SERVE_PROMPTS[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen, device=dev)
    logits, dense = model.prefill(prompts, model.init_cache(b, SERVE_MAX_LEN))
    paged = PagedKVCache(cfg, b, SERVE_MAX_LEN, SERVE_PAGE, device=dev)
    for j in range(b):
        paged.grow_slot(j, plen + 1)
        paged.write_prompt(j, dense.kv.k[:, j, :plen], dense.kv.v[:, j, :plen])
    nxt = logits[:, -1].argmax(-1)[:, None]
    want, dense = model.decode_step(nxt, dense)
    got, _, _ = model.decode_step_paged(nxt, paged.k, paged.v, paged.device_table(),
                                        torch.full((b,), plen, device=dev))
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError(f"paged decode logits differ from dense decode: max |diff| "
                             f"{(got.float() - want.float()).abs().max().item()}")
    for j in range(b):
        pages = torch.tensor(paged.slot_pages(j), device=dev)
        for pool, cache in ((paged.k, dense.kv.k), (paged.v, dense.kv.v)):
            view = pool[:, pages].flatten(1, 2)[:, :plen + 1]
            if not torch.equal(view.view(torch.int16), cache[:, j, :plen + 1].view(torch.int16)):
                raise AssertionError(f"slot {j}: paged k/v differ from the dense cache's")
    log(f"{tag}: decode_step_paged == decode_step bit for bit ({b} rows, "
        f"{SERVE_MAX_LEN // SERVE_PAGE} pages x {SERVE_PAGE} == max_len {SERVE_MAX_LEN}, "
        f"{plen}-token prefill), logits {tuple(got.shape)} {got.dtype} and every written k/v")


def check_serve_steps(torch, dev, model, rows=4, prompt=64, steps=8):
    """``train/step.py::make_serve_steps``' prefill and decode give the
    model methods' greedy tokens on the card, bit for bit in the logits."""
    from repro_torch.train.step import make_serve_steps

    gen = torch.Generator(device=dev).manual_seed(4)
    prompts = torch.randint(0, model.cfg.vocab_size, (rows, prompt), generator=gen, device=dev)
    prefill, decode = make_serve_steps(model)

    def greedy(prefill_fn, decode_fn):
        logits, cache = prefill_fn(prompts, model.init_cache(rows, prompt + steps))
        out = [logits]
        for _ in range(steps):
            logits, cache = decode_fn(logits[:, -1].argmax(-1)[:, None], cache)
            out.append(logits)
        return torch.cat(out, 1)

    got = greedy(lambda p, c: prefill({"tokens": p}, c), decode)
    want = greedy(model.prefill, model.decode_step)
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("make_serve_steps' logits differ from the model methods'")
    log(f"[serve] make_serve_steps: prefill of {rows} x {prompt} and {steps} greedy decode "
        f"steps give the methods' tokens {got.argmax(-1)[0].tolist()}... (row 0), logits "
        f"bit-equal")


def replay_row(torch, dev, model, req, tokens, t):
    """Float32 logits of token ``t`` of ``req``, teacher-forced with
    ``tokens[:t]``: through the static engine's path at one row (the
    oracle's), and through the paged path with the request in row 0 of a
    16-slot step (the continuous engine's shape)."""
    from repro_torch.serve.kvcache import PagedKVCache

    plen = len(req.prompt)
    prompt = torch.from_numpy(req.prompt[None].astype("int64")).to(dev)
    feed = torch.from_numpy(tokens.astype("int64")).to(dev)
    logits, cache = model.prefill(prompt, model.init_cache(1, SERVE_MAX_LEN))
    for i in range(t):
        logits, cache = model.decode_step(feed[i].reshape(1, 1), cache)
    oracle = logits[0, -1].float()
    logits, cache = model.prefill(prompt, model.init_cache(1, plen, rows=1))
    paged = PagedKVCache(model.cfg, SERVE_SLOTS, SERVE_MAX_LEN, SERVE_PAGE, device=dev)
    paged.grow_slot(0, plen)
    paged.write_prompt(0, cache.kv.k[:, 0], cache.kv.v[:, 0])
    for i in range(t):
        paged.grow_slot(0, plen + i + 1)
        toks = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int64, device=dev)
        toks[0] = feed[i]
        lens = torch.zeros((SERVE_SLOTS,), dtype=torch.int64, device=dev)
        lens[0] = plen + i
        logits, _, _ = model.decode_step_paged(toks, paged.k, paged.v, paged.device_table(),
                                               lens)
    return oracle, logits[0, -1].float()


def check_against_oracle(torch, dev, model, requests, results):
    """Check (b): the continuous engine's tokens against the static engine
    run one request at a time, token for token. A differing token passes
    only as a near-tie that float rounding explains: at the first one, the
    oracle's top-2 logit gap is no larger than the largest |logit
    difference| between the two paths' rows at that step (``replay_row``).
    Every divergence is printed."""
    from repro_torch.serve.engine import ServeEngine

    got = {r.rid: r.tokens for r in results}
    divergences = []
    t0 = time.perf_counter()
    for req in requests:
        want = ServeEngine(model, batch_size=1, max_len=SERVE_MAX_LEN).run([req])[0].tokens
        mine = got[req.rid]
        if len(mine) != len(want):
            raise AssertionError(f"rid {req.rid}: {len(mine)} tokens, the oracle {len(want)}")
        differ = [i for i, (a, b) in enumerate(zip(mine, want)) if a != b]
        if not differ:
            continue
        t = differ[0]
        oracle, cont = replay_row(torch, dev, model, req, want, t)
        top2 = oracle.topk(2).values
        gap, diff = float(top2[0] - top2[1]), float((oracle - cont).abs().max())
        div = {"rid": req.rid, "step": t, "gap": gap, "max_abs_logit_diff": diff,
               "oracle_token": int(want[t]), "continuous_token": int(mine[t]),
               "replay_argmax": int(cont.argmax())}
        divergences.append(div)
        log(f"[serve] divergence: {json.dumps(div)}")
        if gap > diff:
            raise AssertionError(f"rid {req.rid} diverges from the oracle at token {t} with "
                                 f"a top-2 gap {gap} above the paths' logit difference {diff}")
    log(f"[serve] check (b): continuous == static at batch_size=1 on {len(requests)} "
        f"requests ({sum(len(got[r.rid]) for r in requests)} tokens), "
        f"{len(divergences)} near-tie divergences; oracle runs "
        f"{time.perf_counter() - t0:.2f} s")
    return divergences


def check_telemetry(eng, results, what):
    """Check (c): the totals that went through the cuda aggregator equal
    the engine's host counts."""
    host = {"requests": len(results), "tokens_generated": sum(len(r.tokens) for r in results)}
    got = {k: eng.telemetry[k] for k in host}
    if got != host or eng.aggregator is None:
        raise AssertionError(f"{what} telemetry through {eng.aggregator}: {got} != host {host}")
    return eng.telemetry_channel.reductions


def serve_path(torch, dev):
    """The fifth slice's path: full-width qwen1.5-0.5b (bf16 weights from a
    seed) served on the card, in the one-rank NCCL group, through
    ``repro_torch.serve``. Check (a), then the continuous engine (16 slots,
    max_len 1024, pages of 16) on a 32-request Poisson trace and the static
    engine (batch 16) on the same requests, both with ``fpisa`` telemetry
    (the ``serve`` path: every kernel's count zeroed just before, read just
    after); checks (c) and (d); check (b) on the first 6 requests; then 8
    requests through the continuous engine with ``fpisa_seq`` telemetry (the
    ``serve_fpisa_seq`` path, traced: ``serve.prefill`` / ``serve.decode``
    spans). Then a decode step and prefills on CUDA events, and
    ``diagnose`` of a decode step. Returns {path: launches}."""
    from repro_torch import trace
    from repro_torch.configs import get_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.models.registry import build
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.loadgen import PoissonLoadGen, latency_report
    from repro_torch.serve.scheduler import ContinuousEngine, _decode_fused

    cfg = get_config("qwen1.5-0.5b")
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    model = build(cfg, device=dev, seed=0)
    check_paged_equals_dense(torch, dev, model)
    check_serve_steps(torch, dev, model)
    torch.cuda.empty_cache()
    arrivals = PoissonLoadGen(rate=SERVE_RATE, prompt_lens=SERVE_PROMPTS, max_new=SERVE_BUDGETS,
                              vocab_size=cfg.vocab_size, seed=0).trace(SERVE_REQUESTS)
    requests = [r for _, r in arrivals]
    paths = {}

    zero_launches()
    cont = ContinuousEngine(model, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                            page_size=SERVE_PAGE, agg=AggConfig(strategy="fpisa"))
    cont_res = cont.run_trace(arrivals)
    torch.cuda.synchronize()
    cont_wall = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    static = ServeEngine(model, batch_size=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                         agg=AggConfig(strategy="fpisa"))
    static_res = static.run(requests)
    torch.cuda.synchronize()
    static_wall = time.perf_counter() - t0
    paths["serve"] = read_launches()
    flushes = (check_telemetry(cont, cont_res, "continuous")
               + check_telemetry(static, static_res, "static"))
    check_fpisa_launches(paths["serve"], flushes, "serve telemetry (one per flush)")
    cont_tok = sum(len(r.tokens) for r in cont_res)
    static_tok = sum(len(r.tokens) for r in static_res)
    rep = latency_report(cont.latency_stats())
    log(f"[serve] continuous ({SERVE_SLOTS} slots, max_len {SERVE_MAX_LEN}, pages of "
        f"{SERVE_PAGE}): {len(cont_res)} requests, {cont_tok} tokens in {cont.last_wall_s:.2f} s "
        f"(last_wall_s) = {cont_tok / cont.last_wall_s:.1f} tok/s; "
        f"{cont.telemetry['decode_steps']} decode steps, {cont.telemetry['prefills']} "
        f"prefill groups; TTFT p50/p99 {rep['ttft_p50']:.2f}/{rep['ttft_p99']:.2f} steps, "
        f"TPOT p50/p99 {rep['tpot_p50']:.2f}/{rep['tpot_p99']:.2f} steps; peak "
        f"{cont.cache.peak_pages_in_use} pages x {SERVE_PAGE} = "
        f"{cont.cache.peak_pages_in_use * SERVE_PAGE} tokens vs dense "
        f"{cont.cache.dense_equivalent_tokens}; model build + check (a) + run "
        f"{cont_wall:.2f} s")
    log(f"[serve] static (batch {SERVE_SLOTS}): {len(static_res)} requests, {static_tok} tokens "
        f"in {static_wall:.2f} s = {static_tok / static_wall:.1f} tok/s; "
        f"{static.telemetry['decode_steps']} decode steps, {static.telemetry['slot_steps']} "
        f"slot steps, truncated_by_packing {static.telemetry['truncated_by_packing']}")
    log(f"[serve] check (c), (d): telemetry through {cont.aggregator} equals the host counts "
        f"(continuous {cont.telemetry['requests']} requests / "
        f"{cont.telemetry['tokens_generated']} tokens, static {static.telemetry['requests']} / "
        f"{static.telemetry['tokens_generated']}); {flushes} flushes, launches "
        f"{json.dumps(paths['serve'])}")
    divergences = check_against_oracle(torch, dev, model, requests[:ORACLE_REQUESTS], cont_res)

    zero_launches()
    tr = trace.enable()
    seq = ContinuousEngine(model, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                           page_size=SERVE_PAGE, agg=AggConfig(strategy="fpisa_seq"))
    seq_res = seq.run_trace(arrivals[:SEQ_REQUESTS])
    trace.disable()
    paths["serve_fpisa_seq"] = read_launches()
    seq_flushes = check_telemetry(seq, seq_res, "continuous fpisa_seq")
    check_seq_launches(paths["serve_fpisa_seq"], seq_flushes, "serve_fpisa_seq telemetry")
    want = {r.rid: r.tokens for r in cont_res}
    same = sum(len(r.tokens) == len(want[r.rid]) and bool((r.tokens == want[r.rid]).all())
               for r in seq_res)
    spans = {name: [x for x in tr.spans if x["name"] == name]
             for name in ("serve.prefill", "serve.decode")}
    by_len = {}
    for x in spans["serve.prefill"]:
        by_len.setdefault(x["tags"]["plen"], []).append(
            (x["tags"]["n"], x["dur"] * 1e3))
    log(f"[serve] fpisa_seq ({SEQ_REQUESTS} requests, traced: each span waits for the "
        f"card): {same} of {len(seq_res)} requests' tokens equal the 32-request run's; "
        f"{seq_flushes} flushes, launches "
        f"{json.dumps(paths['serve_fpisa_seq'])}; prefill per admission group (prompt length: "
        f"[(group size, ms)]) {json.dumps(by_len)}; decode step median "
        f"{statistics.median(x['dur'] for x in spans['serve.decode']) * 1e3:.2f} ms over "
        f"{len(spans['serve.decode'])} steps (host clock)")

    # a decode step and prefills on CUDA events
    nxt = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32, device=dev)
    table = cont.cache.device_table()  # every slot retired: all on the scratch page
    lens = torch.zeros((SERVE_SLOTS,), dtype=torch.int64, device=dev)

    def decode():
        return _decode_fused(model, nxt, cont.cache.k, cont.cache.v, table, lens)

    dense = model.init_cache(SERVE_SLOTS, SERVE_MAX_LEN)._replace(pos=SERVE_MAX_LEN // 2)
    times = {"decode_paged_ms": median_ms(torch, decode, reps=20),
             "decode_dense_ms": median_ms(torch, lambda: model.decode_step(nxt, dense),
                                          reps=20)}
    del dense
    for plen in SERVE_PROMPTS:
        prompt = torch.zeros((1, plen), dtype=torch.int64, device=dev)
        times[f"prefill_{plen}_ms"] = median_ms(
            torch, lambda: model.prefill(prompt, model.init_cache(1, plen, rows=1)),
            reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] CUDA events, median: decode step of {SERVE_SLOTS} slots over ({SERVE_SLOTS}, "
        f"{SERVE_MAX_LEN}) gathered views {times['decode_paged_ms']:.2f} ms, dense "
        f"{times['decode_dense_ms']:.2f} ms; prefill of one sequence "
        + ", ".join(f"{p} tokens {times[f'prefill_{p}_ms']:.2f} ms" for p in SERVE_PROMPTS)
        + f"; peak memory {peak:.2f} GiB; phase {time.perf_counter() - t_phase:.1f} s")
    log(json.dumps({"serve": {
        "continuous": {"requests": len(cont_res), "tokens": cont_tok,
                       "last_wall_s": cont.last_wall_s, "tok_per_s": cont_tok / cont.last_wall_s,
                       "decode_steps": cont.telemetry["decode_steps"],
                       "prefills": cont.telemetry["prefills"], "latency_steps": rep,
                       "peak_pages": cont.cache.peak_pages_in_use},
        "static": {"requests": len(static_res), "tokens": static_tok, "wall_s": static_wall,
                   "tok_per_s": static_tok / static_wall,
                   "decode_steps": static.telemetry["decode_steps"]},
        "divergences": divergences, "times": times, "peak_gib": peak}}))
    diagnose(torch, decode, "serve decode (one paged step, 16 slots)")
    return paths


def family_train(torch, dev, cfg, strategy, seq_len=SEQ_LEN, tag="[models]"):
    """3 steps of ``cfg`` at GLOBAL_BATCH x ``seq_len`` through
    ``train_loop`` with ``strategy`` on the auto backend, every kernel's
    count zeroed just before and read just after. Returns (launches, model,
    opt_state, seconds)."""
    from repro_torch.core.agg import AggConfig
    from repro_torch.launch.train import train_loop

    zero_launches()
    t0 = time.perf_counter()
    model, opt_state, losses = train_loop(
        cfg, steps=STEPS, global_batch=GLOBAL_BATCH, seq_len=seq_len,
        agg=AggConfig(strategy=strategy, backend="auto"), device=dev, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    params = list(model.parameters())
    leaves = len(params)
    want = {"fpisa": K1K2, "fpisa_seq": ("fpisa_accum", "fpisa_accum@leaf")}[strategy]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{cfg.name}: non-finite loss {losses}")
    if strategy == "fpisa":
        check_fpisa_launches(launches, leaves * STEPS, f"{cfg.name} fpisa",
                             leaf=sum(p.dtype != torch.float32 for p in params) * STEPS)
    else:
        check_seq_launches(launches, leaves * STEPS, f"{cfg.name} {strategy}")
    check_s1_launches(launches, cfg, STEPS, f"{cfg.name} {strategy}")
    check_o1_launches(launches, STEPS, f"{cfg.name} {strategy}", leaves)
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError(f"{cfg.name}: non-finite parameter after training")
    log(f"{tag} {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}): {STEPS} steps "
        f"of {GLOBAL_BATCH} x {seq_len} with {strategy}, remat {cfg.remat}, in {wall:.2f} s "
        f"(init included), "
        f"losses {losses}; {leaves} gradient leaves ({sum(p.numel() for p in model.parameters()):,}"
        f" parameters), launches {json.dumps({k: launches[k] for k in want + S1})} (K1: two modes "
        f"a leaf) for {leaves} leaves a step; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {CARD}")
    return launches, model, opt_state, wall


def models_mamba2(torch, dev):
    """(a) mamba2-780m, the whole published config (48 layers, d_model 1536,
    state 128, vocab 50280; bf16 weights from a seed): 3 steps with
    ``fpisa`` (K1/K2 once per leaf per step), cuda == plain aggregation of
    its gradients, the step's breakdown and peak memory, ``diagnose`` of a
    forward+backward (kernel time by name); then the static
    engine serves 8 seeded requests with ``fpisa`` telemetry (exact totals,
    K1/K2 once per flush). Returns the path's launches: each run's counts,
    zeroed (or read) just before it and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.loadgen import PoissonLoadGen

    cfg = get_config("mamba2-780m")
    torch.cuda.reset_peak_memory_stats()
    launches, model, opt_state, _ = family_train(torch, dev, cfg, "fpisa")
    check_grads_cuda_equals_plain(torch, dev, model, "fpisa")
    torch.cuda.reset_peak_memory_stats()
    parts = step_breakdown(torch, dev, model, opt_state, "fpisa")
    peak = torch.cuda.max_memory_allocated() / 2**30
    total = sum(parts.values())
    log(f"[models] (a) {cfg.name} step, CUDA events: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in parts.items())
        + f"; {total:.2f} ms = {GLOBAL_BATCH * SEQ_LEN / total * 1e3:,.0f} tok/s; peak memory "
        f"of the step {peak:.2f} GiB; {CARD}")
    del opt_state
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(ShardedLoader(SyntheticCorpus(cfg.vocab_size, 0), GLOBAL_BATCH,
                                            SEQ_LEN).batch_at(STEPS)["tokens"]).to(dev)
    params = list(model.parameters())
    diagnose(torch, lambda: torch.autograd.grad(model.loss({"tokens": tokens}), params),
             f"{cfg.name} forward+backward of {GLOBAL_BATCH} x {SEQ_LEN} ({CARD})")
    del tokens, params

    requests = [r for _, r in PoissonLoadGen(
        rate=SERVE_RATE, prompt_lens=SERVE_PROMPTS, max_new=(32, 64),
        vocab_size=cfg.vocab_size, seed=1).trace(MODEL_REQUESTS)]
    before = read_launches()
    t0 = time.perf_counter()
    eng = ServeEngine(model, batch_size=MODEL_REQUESTS, max_len=SERVE_MAX_LEN,
                      agg=AggConfig(strategy="fpisa"))
    results = eng.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = read_launches()
    flushes = check_telemetry(eng, results, f"{cfg.name} static")
    check_fpisa_launches({k: after[k] - before[k] for k in after}, flushes,
                         f"{cfg.name} serving telemetry (one per flush)")
    tokens = sum(len(r.tokens) for r in results)
    log(f"[models] (a) {cfg.name} static engine (batch {MODEL_REQUESTS}, max_len "
        f"{SERVE_MAX_LEN}): {len(results)} requests, {tokens} tokens in {wall:.2f} s = "
        f"{tokens / wall:.1f} tok/s, {eng.telemetry['decode_steps']} decode steps; telemetry "
        f"through {eng.aggregator} == the host counts ({eng.telemetry['requests']} requests / "
        f"{eng.telemetry['tokens_generated']} tokens), {flushes} flushes; {CARD}")
    # the path: the training run's launches and the serving run's (the
    # comparisons between them are not counted)
    return {k: launches[k] + after[k] - before[k] for k in launches}


def models_zamba2(torch, dev):
    """(b) zamba2-7b at full width (d_model 3584, d_ff 14336, state 64, the
    shared attention block after every 6 mamba blocks), ``num_layers`` cut
    to 7: one group of 6 and one tail block, so the shared block runs once.
    3 steps with ``fpisa_seq`` (K6 once per leaf per step), cuda == plain
    ``fpisa_seq`` aggregation of its gradients, the step's breakdown."""
    from repro_torch.configs import get_config

    cfg = get_config("zamba2-7b").with_(num_layers=ZAMBA_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    launches, model, opt_state, _ = family_train(torch, dev, cfg, "fpisa_seq")
    check_grads_cuda_equals_plain(torch, dev, model, "fpisa_seq")
    parts = step_breakdown(torch, dev, model, opt_state, "fpisa_seq")
    total = sum(parts.values())
    log(f"[models] (b) {cfg.name} (num_layers cut 81 -> {ZAMBA_LAYERS}) step, CUDA events: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
        + f"; {total:.2f} ms = {GLOBAL_BATCH * SEQ_LEN / total * 1e3:,.0f} tok/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {CARD}")
    return launches


def models_arctic(torch, dev):
    """(c) arctic-480b at full width (d_model 7168, 128 experts top-2, d_ff
    4864, moe_dense_ff 4864, 56 heads / 8 KV heads), ``num_layers`` cut to
    1 (one layer's experts hold 13.39 B parameters, 26.8 GB in bf16).
    ``decode_step_paged`` == ``decode_step`` bit for bit at 16 rows; the
    continuous engine serves a seeded trace of 16 requests with ``fpisa``
    telemetry (exact totals, K1/K2 once per flush: the path's counts zeroed
    just before and read just after); a decode step of 16 slots on CUDA
    events against its byte bound and its ``diagnose``; the expert
    overflows of the run."""
    from repro_torch.configs import get_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.models import moe
    from repro_torch.models.registry import build
    from repro_torch.serve.loadgen import PoissonLoadGen, latency_report
    from repro_torch.serve.scheduler import ContinuousEngine, _decode_fused

    cfg = get_config("arctic-480b").with_(num_layers=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in model.parameters())
    experts = sum(p.numel() for n, p in model.named_parameters() if ".moe.w" in n)
    log(f"[models] (c) {cfg.name} (num_layers cut 35 -> 1): {params:,} parameters, "
        f"{experts:,} in the experts, built in {time.perf_counter() - t0:.2f} s; {CARD}")
    moe.OVERFLOWS.read()
    check_paged_equals_dense(torch, dev, model, tag=f"[models] (c) {cfg.name} check")
    arrivals = PoissonLoadGen(rate=SERVE_RATE, prompt_lens=SERVE_PROMPTS, max_new=(32, 64),
                              vocab_size=cfg.vocab_size, seed=2).trace(MODEL_REQUESTS * 2)
    zero_launches()
    moe.OVERFLOWS.read()
    eng = ContinuousEngine(model, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                           page_size=SERVE_PAGE, agg=AggConfig(strategy="fpisa"))
    results = eng.run_trace(arrivals)
    torch.cuda.synchronize()
    launches = read_launches()
    overflows = moe.OVERFLOWS.read()
    flushes = check_telemetry(eng, results, f"{cfg.name} continuous")
    check_fpisa_launches(launches, flushes, f"{cfg.name} serving telemetry (one per flush)")
    tokens = sum(len(r.tokens) for r in results)
    rep = latency_report(eng.latency_stats())
    log(f"[models] (c) {cfg.name} continuous ({SERVE_SLOTS} slots, max_len {SERVE_MAX_LEN}, "
        f"pages of {SERVE_PAGE}): {len(results)} requests, {tokens} tokens in "
        f"{eng.last_wall_s:.2f} s = {tokens / eng.last_wall_s:.1f} tok/s, "
        f"{eng.telemetry['decode_steps']} decode steps, {eng.telemetry['prefills']} prefill "
        f"groups, TTFT p50 {rep['ttft_p50']:.2f} steps; telemetry == the host counts, "
        f"{flushes} flushes, launches {json.dumps(launches)}; expert queues that overflowed "
        f"(group, expert, summed over layers and calls): {overflows}; {CARD}")

    nxt = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32, device=dev)
    table = eng.cache.device_table()
    lens = torch.full((SERVE_SLOTS,), SERVE_MAX_LEN // 2, dtype=torch.int64, device=dev)
    ms = median_ms(torch, lambda: _decode_fused(model, nxt, eng.cache.k, eng.cache.v, table,
                                                lens), reps=10, warmup=2)
    # bytes a decode step must move: every weight once (the embedding's 16
    # rows only), each slot's gathered K/V view, the logits written
    elem = 2
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    weights -= model.embed["tok"].numel() * elem - SERVE_SLOTS * cfg.d_model * elem
    kv = 2 * SERVE_SLOTS * SERVE_MAX_LEN * cfg.num_kv_heads * cfg.resolved_head_dim * elem
    out = SERVE_SLOTS * cfg.vocab_size * elem
    expert_bytes = 3 * cfg.num_experts * cfg.d_model * cfg.d_ff * elem
    bound = (weights + kv + out) / HBM_BYTES_PER_S * 1e3
    log(f"[models] (c) {cfg.name} decode step of {SERVE_SLOTS} slots, CUDA events median of "
        f"10: {ms:.2f} ms; byte bound {bound:.2f} ms ({(weights + kv + out) / 1e9:.2f} GB at "
        f"3.35 TB/s; the experts alone {expert_bytes / 1e9:.2f} GB = "
        f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms), {100 * bound / ms:.1f} % of it; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {CARD}")
    diagnose(torch, lambda: _decode_fused(model, nxt, eng.cache.k, eng.cache.v, table, lens),
             f"{cfg.name} decode step of {SERVE_SLOTS} slots ({CARD})")
    return launches, {"decode_ms": ms, "bound_ms": bound, "overflows": overflows}


def remat_grads(torch, model, batch, mode):
    """Loss and gradients of one forward+backward under remat ``mode``, and
    A1's launches in it, in all and by route (counts zeroed just before,
    read just after)."""
    model.cfg = model.cfg.with_(remat=mode)
    zero_launches()
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    return [loss.detach()] + list(grads), a1_subset(read_launches())


def check_remat_a1(counts, cfg, mode, what):
    """A1's launches in one forward+backward of the dense ``cfg`` under
    remat ``mode``: the forward once per layer, once more in the recompute
    unless ``mode`` is "none"; the backward once per layer."""
    want = [(1 if mode == "none" else 2) * cfg.num_layers, cfg.num_layers]
    if [counts[k] for k in A1] != want:
        raise AssertionError(f"{what}, remat {mode}: A1 launched {[counts[k] for k in A1]} "
                             f"(forward, backward) in one forward+backward, expected {want}")


def same_bits_all(torch, a, b):
    """Whether the tensors of ``a`` and ``b`` hold the same bits, pair by
    pair (float32 or 16-bit; 0-d tensors too)."""
    ints = {4: torch.int32, 2: torch.int16}
    return all(x.dtype == y.dtype and torch.equal(x.view(ints[x.element_size()]),
                                                  y.view(ints[y.element_size()]))
               for x, y in zip(a, b))


def qwen_remat(torch, dev):
    """(d) qwen1.5-0.5b at full width, 8 x 512 tokens. First the slice's
    path (``dots``): 3 steps with remat "dots" through ``train_loop`` with
    ``fpisa``, every count zeroed just before and read just after: K1's
    exponent and wire modes and K2 once per leaf per step, A1 forward twice
    per layer per step (the recompute replays it) and backward once. Then,
    on the trained weights, a forward+backward under "full" (each layer
    recomputed in the backward, the configs' default), "none" and "dots"
    (recomputed but for the products with no batch dimension): A1's
    launches of each; the loss bit for bit and the gradients of "dots"
    against "full"'s: bit for bit where "full" repeats "none"'s bits, else
    within ``DOTS_TOL`` of each leaf's largest |entry|; ``remat_timing``'s
    numbers for each. Returns (the path's launches, numbers)."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen1.5-0.5b")
    torch.cuda.reset_peak_memory_stats()
    launches, model, opt_state, _ = family_train(torch, dev, cfg.with_(remat="dots"), "fpisa",
                                                 tag="[models] (d)")
    check_a1_launches(launches, cfg, STEPS, "dots")
    del opt_state
    torch.cuda.empty_cache()
    batch = training_batch(torch, dev, cfg)
    runs, a1 = {}, {}
    for mode in REMATS:
        runs[mode], counts = remat_grads(torch, model, batch, mode)
        check_remat_a1(counts, cfg, mode, f"{cfg.name} {GLOBAL_BATCH} x {SEQ_LEN}")
        a1[mode] = [counts[k] for k in A1]
    if not same_bits_all(torch, runs["dots"][:1], runs["full"][:1]):
        raise AssertionError(f"remat dots: loss {runs['dots'][0]} != full's {runs['full'][0]}")
    if same_bits_all(torch, runs["full"], runs["none"]):
        how = "bit for bit (full repeats none's bits)"
        if not same_bits_all(torch, runs["dots"], runs["full"]):
            raise AssertionError("remat dots: gradients differ from full's bits")
    else:
        how = f"within {DOTS_TOL} of each leaf's largest |entry| (full differs from none)"
        for g, f in zip(runs["dots"][1:], runs["full"][1:]):
            if float((g.float() - f.float()).abs().max()) > DOTS_TOL * float(f.float().abs().max()):
                raise AssertionError(f"remat dots: a gradient leaf off full's by more than {how}")
    del runs
    res = remat_timing(torch, model, batch, REMATS, reps=5)
    log(f"[models] (d) {cfg.name} forward+backward of {GLOBAL_BATCH} x {SEQ_LEN}: "
        + remat_report(res) + f"; dots: loss == full's bit for bit, gradients == full's {how}; "
        f"A1 launches (forward, backward) of one forward+backward: "
        + ", ".join(f"{m} {a1[m]}" for m in REMATS) + f"; {CARD}")
    del model
    torch.cuda.empty_cache()
    return launches, {"timing": res, "grads": how, "a1": a1}


def remat_timing(torch, model, batch, modes, reps):
    """One forward+backward of ``batch`` under each remat of ``modes``: CUDA
    events, median of ``reps``, two turns of the modes in turn, and the
    peak memory; then per mode the host's issue time against CUDA events
    (median of 5) and torch.profiler's kernel time and launches of one run.
    Returns {mode: numbers}."""
    cfg, params = model.cfg, list(model.parameters())

    def run():
        torch.autograd.grad(model.loss(batch), params)

    out = {m: {"ms": []} for m in modes}
    for mode in modes * 2:
        model.cfg = cfg.with_(remat=mode)
        torch.cuda.reset_peak_memory_stats()
        out[mode]["ms"].append(median_ms(torch, run, reps=reps, warmup=1))
        out[mode]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for mode in modes:
        model.cfg = cfg.with_(remat=mode)
        out[mode]["issue_ms"], out[mode]["events_ms"] = issue_vs_device(torch, run)
        out[mode]["kernels_ms"], out[mode]["kernel_launches"] = (
            device_profile(torch, run) or (None, None))
    model.cfg = cfg
    return out


def remat_report(res, tokens=None):
    """``remat_timing``'s numbers as a line's words."""
    def one(m, r):
        kern = (f"{r['kernels_ms']:.2f} ms of kernels in {r['kernel_launches']} launches"
                if r["kernels_ms"] else "kernels not measured")
        rate = f", {tokens / statistics.median(r['ms']) * 1e3:,.0f} tok/s" if tokens else ""
        return (f"remat {m} {[round(t, 2) for t in r['ms']]} ms (CUDA events, two turns{rate}; "
                f"host issue {r['issue_ms']:.2f} ms against {r['events_ms']:.2f} ms of events; "
                f"{kern}; peak {r['peak_gib']:.2f} GiB)")
    return ", ".join(one(m, r) for m, r in res.items())


def models_path(torch, dev):
    """The seventh slice's paths (``[models]`` lines): (a) mamba2-780m
    trained at full size and served, (b) zamba2-7b at full width trained
    with ``fpisa_seq``, (c) arctic-480b at full width served, (d) qwen
    trained with remat "dots" (path ``dots``) and its forward+backward under
    each remat. Returns {path: launches}."""
    t0 = time.perf_counter()
    paths = {"mamba2": models_mamba2(torch, dev)}
    torch.cuda.empty_cache()
    paths["zamba2_seq"] = models_zamba2(torch, dev)
    torch.cuda.empty_cache()
    paths["arctic_serve"], arctic = models_arctic(torch, dev)
    torch.cuda.empty_cache()
    paths["dots"], remat = qwen_remat(torch, dev)
    torch.cuda.empty_cache()
    log(f"[models] the group took {time.perf_counter() - t0:.1f} s; {CARD}")
    log(json.dumps({"models": {"arctic": arctic, "qwen_remat": remat}}))
    return paths


# ---------------------------------------------------------------------------
# the eighth slice: the encoder-decoder (whisper-medium)
# ---------------------------------------------------------------------------


def encdec_train(torch, dev):
    """(a) whisper-medium at its published size (24 encoder and 24 decoder
    layers, d_model 1024, 16 heads, d_ff 4096, vocab 51865, 1500 frames;
    812,036,096 parameters in 26 leaves, bf16 weights from a seed): 3 steps
    of 8 x 448 decoder tokens over 8 x 1500 seeded frames through
    ``train_loop`` with ``fpisa`` (K1/K2 once per leaf per step, the path's
    counts zeroed just before and read just after), cuda == plain
    aggregation of its gradients on the same batch, the step's breakdown,
    decoder tokens/s and frames/s, peak memory, and ``diagnose`` of a
    forward+backward. Returns (launches, model, numbers)."""
    from repro_torch.configs import get_config

    cfg = get_config("whisper-medium")
    torch.cuda.reset_peak_memory_stats()
    launches, model, opt_state, _ = family_train(torch, dev, cfg, "fpisa", seq_len=WHISPER_SEQ,
                                                 tag="[encdec] (a)")
    size = (sum(p.numel() for p in model.parameters()), len(list(model.parameters())))
    if size != (WHISPER_PARAMS, WHISPER_LEAVES):
        raise AssertionError(f"{cfg.name}: {size[0]:,} parameters in {size[1]} leaves, expected "
                             f"{WHISPER_PARAMS:,} in {WHISPER_LEAVES}")
    check_grads_cuda_equals_plain(torch, dev, model, "fpisa", seq_len=WHISPER_SEQ)
    torch.cuda.reset_peak_memory_stats()
    parts = step_breakdown(torch, dev, model, opt_state, "fpisa", seq_len=WHISPER_SEQ)
    peak = torch.cuda.max_memory_allocated() / 2**30
    total = sum(parts.values())
    tok_s = GLOBAL_BATCH * WHISPER_SEQ / total * 1e3
    frames_s = GLOBAL_BATCH * cfg.num_frames / total * 1e3
    log(f"[encdec] (a) {cfg.name} step, CUDA events: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in parts.items())
        + f"; {total:.2f} ms = {tok_s:,.0f} decoder tok/s, {frames_s:,.0f} frames/s; peak "
        f"memory of the step {peak:.2f} GiB; {CARD}")
    del opt_state
    torch.cuda.empty_cache()
    batch = training_batch(torch, dev, cfg, WHISPER_SEQ)
    params = list(model.parameters())
    diagnose(torch, lambda: torch.autograd.grad(model.loss(batch), params),
             f"{cfg.name} forward+backward of {GLOBAL_BATCH} x {WHISPER_SEQ} tokens over "
             f"{GLOBAL_BATCH} x {cfg.num_frames} frames ({CARD})")
    return launches, model, {"step_ms": parts, "decoder_tok_s": tok_s, "frames_s": frames_s,
                             "peak_gib": peak}


def serve_inputs(torch, dev, cfg, rows):
    """``rows`` seeded float32 frame sequences (numpy seed 5) and
    ``WHISPER_PROMPT``-token prompts, on the card."""
    import numpy as np

    rng = np.random.default_rng(5)
    frames = rng.standard_normal((rows, cfg.num_frames, cfg.d_model), dtype=np.float32)
    prompt = rng.integers(0, cfg.vocab_size, (rows, WHISPER_PROMPT), dtype=np.int32)
    return torch.from_numpy(frames).to(dev), torch.from_numpy(prompt).to(dev)


def encdec_serve_checks(torch, dev, model):
    """(b) the serving half at full width, on a float32 copy of the trained
    weights: 8 rows of 1500 seeded frames and a 4-token prompt. Prefill's
    last-position logits equal ``forward``'s last position, and each of 32
    greedy ``decode_step``s equals a fresh ``forward`` over the extended
    tokens at that position (the reference's check, tests/test_models.py),
    within ``WHISPER_ATOL``; then the cached cross K/V equal
    ``encode_cross_kv`` of the encoder states bit for bit (written once at
    prefill and left alone by the decode steps)."""
    from repro_torch.interop import params_from_jax, params_to_jax
    from repro_torch.models import attention as attn
    from repro_torch.models.registry import build

    cfg = model.cfg.with_(param_dtype="float32", activation_dtype="float32")
    # params_to_jax gives the bf16 leaves as float32 numpy arrays
    m32 = build(cfg, device=dev, params=params_from_jax(params_to_jax(model)))
    rows = WHISPER_ROWS[0]
    frames, tokens = serve_inputs(torch, dev, cfg, rows)
    logits, cache = m32.prefill(tokens, m32.init_cache(rows, WHISPER_PROMPT + WHISPER_DECODE),
                                frames)
    errs = []
    with torch.inference_mode():
        for step in range(WHISPER_DECODE + 1):
            if step:
                nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                logits, cache = m32.decode_step(nxt, cache)
                tokens = torch.cat([tokens, nxt], dim=1)
            full, _ = m32({"frames": frames, "tokens": tokens})
            errs.append((logits[:, -1] - full[:, -1]).abs().max().item())
            what = "prefill" if step == 0 else f"decode step {step}"
            if not (errs[-1] <= WHISPER_ATOL and torch.isfinite(logits).all()):
                raise AssertionError(f"{cfg.name} float32 {what}: logits differ from a fresh "
                                     f"forward by {errs[-1]:.3g} (tolerance {WHISPER_ATOL})")
        enc = m32.encode(frames)
        for i, lp in enumerate(m32._dec_views()):
            k, v = attn.encode_cross_kv(lp["xattn"], enc)
            if not (torch.equal(cache.cross_kv[0][i], k) and torch.equal(cache.cross_kv[1][i], v)):
                raise AssertionError(f"{cfg.name}: cached cross K/V of decoder layer {i} differ "
                                     f"from encode_cross_kv of the encoder states")
    log(f"[encdec] (b) {cfg.name} serving checks on a float32 copy ({rows} rows x "
        f"{cfg.num_frames} frames, {WHISPER_PROMPT}-token prompt): prefill == forward's last "
        f"position (max |diff| {errs[0]:.3g}), {WHISPER_DECODE} greedy decode steps == a fresh "
        f"forward over the extended tokens (max |diff| {max(errs[1:]):.3g}; tolerance "
        f"{WHISPER_ATOL} absolute, largest |logit| {full.abs().max().item():.3g}); the cached "
        f"cross K/V of all {cfg.num_layers} layers == encode_cross_kv bit for bit; {CARD}")
    return {"prefill_max_abs_diff": errs[0], "decode_max_abs_diff": max(errs[1:])}


def decode_bytes(model, rows, pos):
    """Bytes a decode step at ``pos`` must move for ``rows`` rows: every
    decoder weight it uses once (not the cross ``wk``/``wv``, which only
    prefill uses), the final norm, the head and the rows' embeddings; each
    row's cross K/V (every layer, every frame) and self K/V at [0, pos]
    read; the logits written. Returns (total, weights, cross K/V)."""
    cfg = model.cfg
    skip = ("dec_layers.xattn.wk", "dec_layers.xattn.wv")
    weights = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                  if (n.startswith("dec_layers.") and n not in skip)
                  or n in ("final_norm.w", "head.w"))
    elem = model.embed["tok"].element_size()
    weights += rows * cfg.d_model * elem
    kv = cfg.num_kv_heads * cfg.resolved_head_dim * elem   # one position of one layer
    cross = 2 * cfg.num_layers * rows * cfg.num_frames * kv
    self_kv = 2 * cfg.num_layers * rows * (pos + 1) * kv
    return weights + cross + self_kv + rows * cfg.vocab_size * elem, weights, cross


def encdec_serve_timing(torch, dev, model):
    """The bf16 model's serving half on CUDA events: prefill (4-token
    prompts over 1500 frames) and a decode step at 8 and 16 rows, each
    against the decode step's byte bound (``decode_bytes`` over 3.35
    TB/s), and ``diagnose`` of the 16-row decode step."""
    cfg = model.cfg
    out = {}
    for rows in WHISPER_ROWS:
        frames, prompt = serve_inputs(torch, dev, cfg, rows)
        cache = model.init_cache(rows, WHISPER_PROMPT + WHISPER_DECODE)
        prefill_ms = median_ms(torch, lambda: model.prefill(prompt, cache, frames), reps=5,
                               warmup=1)
        _, cache = model.prefill(prompt, cache, frames)
        nxt = prompt[:, -1:]
        ms = median_ms(torch, lambda: model.decode_step(nxt, cache), reps=10, warmup=2)
        total, weights, cross = decode_bytes(model, rows, cache.pos)
        bound = total / HBM_BYTES_PER_S * 1e3
        log(f"[encdec] (b) {cfg.name} {cfg.param_dtype}, {rows} rows: prefill {prefill_ms:.2f} ms; decode "
            f"step {ms:.2f} ms, CUDA events median of 10; byte bound {bound:.3f} ms "
            f"({total / 1e9:.3f} GB at 3.35 TB/s: weights {weights / 1e9:.3f} GB, cross K/V "
            f"{cross / 1e9:.3f} GB), {100 * bound / ms:.1f} % of it; {CARD}")
        out[rows] = {"prefill_ms": prefill_ms, "decode_ms": ms, "bound_ms": bound}
    diagnose(torch, lambda: model.decode_step(nxt, cache),
             f"{cfg.name} decode step of {rows} rows ({CARD})")
    return out


def encdec_path(torch, dev):
    """The eighth slice's path (``[encdec]`` lines): (a) whisper-medium
    trained at its published size, (b) its serving half checked on a
    float32 copy and timed in bf16. Returns {"whisper": launches}."""
    t0 = time.perf_counter()
    launches, model, train = encdec_train(torch, dev)
    torch.cuda.empty_cache()
    checks = encdec_serve_checks(torch, dev, model)
    torch.cuda.empty_cache()
    serve = encdec_serve_timing(torch, dev, model)
    del model
    torch.cuda.empty_cache()
    log(f"[encdec] the group took {time.perf_counter() - t0:.1f} s; {CARD}")
    log(json.dumps({"encdec": {"train": train, "checks": checks, "serve": serve}}))
    return {"whisper": launches}


def sharding_plain_and_mesh(torch, dev):
    """(a): the same 3 full-width qwen steps twice, plain tensors and on the
    card's (data, model) = (1, 1) DeviceMesh (``sharding.rules.distribute``,
    the mesh step), under deterministic algorithms (both runs repeat their
    bits). K1/K2 and O1 counted from zero over the mesh run. Returns (launches,
    the two models and optimizer states, their losses)."""
    from repro_torch.configs import get_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime.elastic import reproducible

    cfg = get_config("qwen1.5-0.5b")
    agg = AggConfig(strategy="fpisa", backend="auto")
    mesh = make_mesh_for(1, model_parallel=1)
    runs = {}
    with reproducible(dev):
        runs["plain"] = train_loop(cfg, steps=STEPS, global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN,
                                   agg=agg, device=dev, log_every=1)
        torch.cuda.synchronize()
        zero_launches()
        runs["mesh"] = train_loop(cfg, steps=STEPS, global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN,
                                  agg=agg, device=dev, log_every=1, mesh=mesh)
        torch.cuda.synchronize()
        launches = read_launches()
    return launches, runs, mesh


def equal_bits(torch, got, want, what):
    """``got`` and ``want`` hold the same bits (integer views)."""
    ints = {4: torch.int32, 2: torch.int16, 1: torch.int8}
    if not (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.view(ints[got.element_size()]),
                            want.view(ints[want.element_size()]))):
        raise AssertionError(f"{what}: the bits differ")


def pipeline_witness(torch, dev, model, batch, states):
    """Of (b)'s gradients at each of ``states`` ({name: the parameters}),
    which is at fault where they part: the pipeline or (b)'s tolerance. A
    float32 copy of the model (the witness) gives the gradients without
    bf16 rounding; each of the pipeline's (one stage, 4 microbatches) and
    ``model.loss``'s bf16 gradients is measured against it as (b) measures
    the two against each other, the largest |a - w| - 2e-2 |w| of a leaf.
    Where ``model.loss`` is as far from the witness as the pipeline, bf16's
    rounding parts them, not the pipeline. Logs one ``[sharding] (b)
    witness`` line a state; leaves ``model`` at the last state."""
    from repro_torch.models.registry import build
    from repro_torch.train.pipeline import make_pp_loss, param_tree, split_stages

    cfg = model.cfg
    witness = build(cfg.with_(param_dtype="float32", activation_dtype="float32"), device=dev,
                    seed=0)
    names = [n for n, _ in model.named_parameters()]
    if names != [n for n, _ in witness.named_parameters()]:
        raise AssertionError("[sharding] (b) witness: the float32 model's leaves differ")
    params, w_params = list(model.parameters()), list(witness.parameters())
    pp_loss = make_pp_loss(cfg, None, n_micro=4)

    def excess(a, b):
        return float(((a.float() - b.float()).abs() - 2e-2 * b.float().abs()).max())

    for state, values in states.items():
        with torch.no_grad():
            for p, w, x in zip(params, w_params, values):
                p.copy_(x)
                w.copy_(x.float())
        ref_g = torch.autograd.grad(model.loss(batch), params)
        pp_g = torch.autograd.grad(pp_loss(split_stages(param_tree(model), 1), batch), params)
        w_g = torch.autograd.grad(witness.loss(batch), w_params)
        rows = {n: (excess(a, b), excess(a, w), excess(b, w))
                for n, a, b, w in zip(names, pp_g, ref_g, w_g)}
        worst = max(rows, key=lambda n: rows[n][0])
        log(f"[sharding] (b) witness, model {state}: pipeline vs model.loss "
            f"{rows[worst][0]:.3e} at {worst} (atol 2e-4), where pipeline vs float32 "
            f"{rows[worst][1]:.3e} and model.loss vs float32 {rows[worst][2]:.3e}; over all "
            f"leaves pipeline vs float32 {max(r[1] for r in rows.values()):.3e}, model.loss vs "
            f"float32 {max(r[2] for r in rows.values()):.3e}; {CARD}")
        del ref_g, pp_g, w_g
    del witness, w_params
    torch.cuda.empty_cache()


def sharding_path(torch, dev):
    """The ninth slice's path (``[sharding]`` lines): (a) full-width
    qwen1.5-0.5b trained through a (1, 1) DeviceMesh with K1/K2 (path
    ``sharded``) held to the plain-tensor run's losses, parameters and
    aggregated gradient bits, step times beside each other; (b) the GPipe
    loss (``train/pipeline.py``) at full width, one stage, 4
    microbatches, against ``model.loss`` and its gradients, and both
    against a float32 witness (``pipeline_witness``); (c) ``opscan``
    of the mesh step against its measured time, and the dry run's
    per-device bytes of qwen1.5-0.5b and kimi-k2 (multi-pod) against the
    card's memory. Returns {"sharded": launches}."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.agg import AggConfig, Aggregator
    from repro_torch.launch import opscan
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.optim import optimizers
    from repro_torch.runtime.elastic import reproducible
    from repro_torch.sharding import hints
    from repro_torch.train.pipeline import make_pp_loss, param_tree, split_stages
    from repro_torch.train.step import MeshGrads, _swapped, make_train_step

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    dry_cmds = {"qwen1.5-0.5b": ["--arch", "qwen1.5-0.5b", "--shape", "train_4k"],
                "kimi-k2-1t-a32b": ["--arch", "kimi-k2-1t-a32b", "--shape", "train_4k",
                                    "--multi-pod"]}
    # the dry runs trace on the host's CPU, beside the card's work
    dry = {k: subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *a],
                               cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
           for k, a in dry_cmds.items()}
    try:
        launches, runs, mesh = sharding_plain_and_mesh(torch, dev)
        (plain, p_opt, p_losses), (meshed, m_opt, m_losses) = runs["plain"], runs["mesh"]
        leaves = len(list(meshed.parameters()))
        log(f"[sharding] (a) {STEPS} steps on mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}: "
            f"losses {m_losses}, plain {p_losses}; K1/K2 launches "
            f"{json.dumps(k1k2_subset(launches))} ({leaves} leaves); {CARD}")
        check_fpisa_launches(launches, leaves * STEPS, "[sharding] mesh run")
        check_o1_launches(launches, STEPS, "[sharding] mesh run", leaves)
        if m_losses != p_losses:
            raise AssertionError(f"[sharding] mesh losses {m_losses} != plain {p_losses}")
        for (name, a), b in zip(meshed.named_parameters(), plain.parameters()):
            if not isinstance(a, DTensor):
                raise AssertionError(f"[sharding] {name} is not a DTensor")
            equal_bits(torch, a.full_tensor(), b.detach(), f"[sharding] parameter {name}")
        for a, b in zip(m_opt.m + m_opt.v, p_opt.m + p_opt.v):
            equal_bits(torch, a.full_tensor(), b, "[sharding] AdamW moment")
        batch = training_batch(torch, dev, plain.cfg)
        agg = AggConfig(strategy="fpisa", backend="auto")
        plan = MeshGrads(meshed, mesh, agg)
        with reproducible(dev):
            want = Aggregator(agg).allreduce_tree(
                list(torch.autograd.grad(plain.loss(batch), list(plain.parameters()))))
            v = plan.views()
            with _swapped(meshed, v), hints.use_mesh(mesh), implicit_replication():
                grads = torch.autograd.grad(meshed.loss(batch), list(v.values()))
            pairs = [plan.local(g, p) for g, p in zip(grads, v.values())]
            got = plan.aggregate([g for g, _ in pairs], [t for _, t in pairs], v)
        for (name, _), a, b in zip(meshed.named_parameters(), got, want):
            equal_bits(torch, a.full_tensor(), b, f"[sharding] aggregated gradient {name}")
        log(f"[sharding] (a) losses, parameters, AdamW moments and the aggregated gradients "
            f"of all {leaves} leaves: mesh == plain, bit for bit")

        cfg = plain.cfg
        opt_cfg = optimizers.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
        p_step = make_train_step(plain, agg, opt_cfg, GLOBAL_BATCH)
        m_step = make_train_step(meshed, agg, opt_cfg, GLOBAL_BATCH, mesh=mesh)

        def fwd_bwd_mesh():
            vv = plan.views()
            with _swapped(meshed, vv), hints.use_mesh(mesh), implicit_replication():
                torch.autograd.grad(meshed.loss(batch), list(vv.values()))

        def fwd_bwd_plain():
            torch.autograd.grad(plain.loss(batch), list(plain.parameters()))

        # (b) reads the plain model after the timed steps train it; the
        # float32 witness also reads it as the three steps left it
        untimed = [p.detach().clone() for p in plain.parameters()]
        times = {"step_plain": median_ms(torch, lambda: p_step(p_opt, batch), reps=3, warmup=1),
                 "step_mesh": median_ms(torch, lambda: m_step(m_opt, batch), reps=3, warmup=1),
                 "fwd_bwd_plain": median_ms(torch, fwd_bwd_plain, reps=3, warmup=1),
                 "fwd_bwd_mesh": median_ms(torch, fwd_bwd_mesh, reps=3, warmup=1)}
        log(f"[sharding] (a) step {times['step_mesh']:.2f} ms on the mesh, "
            f"{times['step_plain']:.2f} ms plain (main path); forward+backward "
            f"{times['fwd_bwd_mesh']:.2f} / {times['fwd_bwd_plain']:.2f} ms; median of 3, "
            f"CUDA events; {CARD}")

        # (c) opscan of the mesh step, on the card's own cell
        with opscan.OpScan() as scan:
            m_step(m_opt, batch)
        torch.cuda.synchronize()
        an = scan.analysis
        compute_s, memory_s = an.flops / PEAK_FLOPS_BF16, an.hbm_bytes / HBM_BW
        bound_ms = max(compute_s, memory_s) * 1e3
        log(f"[sharding] (c) opscan of one mesh step: {an.flops:.4e} flops "
            f"({an.product_flops:.4e} in products), {an.hbm_bytes:.4e} bytes; "
            f"compute_s {compute_s * 1e3:.2f} ms at 989 TFLOP/s, memory_s "
            f"{memory_s * 1e3:.2f} ms at 3.35 TB/s; measured step {times['step_mesh']:.2f} ms = "
            f"{times['step_mesh'] / bound_ms:.2f}x the bound, forward+backward "
            f"{times['fwd_bwd_mesh']:.2f} ms; {CARD}")
        del p_opt, m_opt, p_step, m_step, plan, meshed, v, grads, pairs, got, want
        torch.cuda.empty_cache()

        # (b) the pipeline loss at full width, one stage
        model = plain
        params = list(model.parameters())
        ref = model.loss(batch)
        ref_g = torch.autograd.grad(ref, params)
        pp_loss = make_pp_loss(cfg, None, n_micro=4)
        pp = pp_loss(split_stages(param_tree(model), 1), batch)
        pp_g = torch.autograd.grad(pp, params)
        dl = abs(float(pp.detach()) - float(ref.detach()))
        worst = max(float(((a.float() - b.float()).abs()
                           - 2e-2 * b.float().abs()).max()) for a, b in zip(pp_g, ref_g))
        pp_ms = median_ms(torch, lambda: torch.autograd.grad(
            pp_loss(split_stages(param_tree(model), 1), batch), params), reps=3, warmup=1)
        log(f"[sharding] (b) pipeline loss (1 stage, 4 microbatches) {float(pp.detach()):.6f} "
            f"vs model.loss {float(ref.detach()):.6f} (|diff| {dl:.3e}, tolerance 2e-3); "
            f"gradients: largest |diff| - 2e-2 |ref| = {worst:.3e} (tolerance atol 2e-4); "
            f"forward+backward {pp_ms:.2f} ms; {CARD}")
        pipeline_witness(torch, dev, model, batch, {"timed": [p.detach().clone() for p in params],
                                                    "untimed": untimed})
        if dl > 2e-3:
            raise AssertionError(f"[sharding] pipeline loss off by {dl}")
        for (name, _), a, b in zip(model.named_parameters(), pp_g, ref_g):
            torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-4,
                                       msg=lambda m, name=name: f"[sharding] (b) {name}: {m}")
        del ref_g, pp_g, untimed
        del model, plain, params, runs
        torch.cuda.empty_cache()
    finally:
        outs = {}
        for k, proc in dry.items():
            out, err = proc.communicate(timeout=600)
            outs[k] = (proc.returncode, out, err)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    for k, (rc, out, err) in outs.items():
        if rc != 0:
            raise AssertionError(f"[sharding] dry run of {k} failed (rc {rc}): {err[-2000:]}")
        rec = json.loads(out.strip().splitlines()[-1])
        if rec["status"] != "ok":
            raise AssertionError(f"[sharding] dry run of {k}: {rec.get('error')}")
        arg = rec["per_device"]["arg_bytes"]
        log(f"[sharding] (c) dry run {k} train_4k on {rec['mesh']}: per_device.arg_bytes "
            f"{arg / 1e9:.2f} GB = {100 * arg / card_bytes:.1f} % of this card's "
            f"{card_bytes / 2**30:.1f} GiB; roofline compute_s {rec['roofline']['compute_s']:.3f}, "
            f"memory_s {rec['roofline']['memory_s']:.3f}, collective_s "
            f"{rec['roofline']['collective_s']:.3f} ({rec['roofline']['bottleneck']}), "
            f"traced in {rec['trace_s']} s")
    log(f"[sharding] the group took {time.perf_counter() - t0:.1f} s; {CARD}")
    return {"sharded": {**k1k2_subset(launches), **a1_subset(launches),
                        **s1_subset(launches), **o1_subset(launches)}}


# ---------------------------------------------------------------------------
# the tenth slice: long context through the chunked attention kernel (A1)
# ---------------------------------------------------------------------------


def check_a1_routes(paths):
    """A1's launches on each path by route. Every driven path runs bf16, so
    each of its launches must have taken the tensor-core (``wgmma``)
    kernels and none the float32 CUDA-core ones. Returns {path: {route:
    [forward, backward]}}."""
    routes = {}
    for path, n in paths.items():
        if not any(n.get(k) for k in A1):
            continue
        routes[path] = {r: [n.get(f"{k}@{r}") for k in A1] for r in ("wgmma", "cuda_cores")}
        if routes[path] != {"wgmma": [n[k] for k in A1], "cuda_cores": [0, 0]}:
            raise AssertionError(f"{path}: A1 launched {[n[k] for k in A1]} (forward, backward), "
                                 f"by route {routes[path]}: a bf16 path off the tensor cores")
    log("[a1 routes] A1 launches (forward, backward) on each path: bf16 on the tensor cores "
        "(wgmma), float32 on the CUDA cores: " + json.dumps(routes))
    return routes


def check_a1_launches(counts, cfg, steps, path):
    """A1's launches over ``steps`` training steps of the dense ``cfg`` with
    remat "full" or "dots": the forward once per layer per step and once
    more in the layer's recompute, the backward once per layer per step.
    Returns A1's counts."""
    want = {"chunked_attention_fwd": 2 * cfg.num_layers * steps,
            "chunked_attention_bwd": cfg.num_layers * steps}
    got = {k: counts[k] for k in A1}
    if got != want:
        raise AssertionError(f"{path}: A1 launched {got} in {steps} steps of {cfg.name}, "
                             f"expected {want}")
    return a1_subset(counts)


def a1_inputs(torch, dev, b, s, sk, h, hd, dtype, seed=0):
    """q, k, v, dout from numpy seed ``seed``: standard normal, on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev).to(dtype)
            for shape in ((b, s, h, hd), (b, sk, h, hd), (b, sk, h, hd), (b, s, h, hd))]


def a1_grads(torch, fn, q, k, v, dout):
    """[output, dq, dk, dv] of ``fn(q, k, v)`` against the cotangent ``dout``."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    return [out.detach()] + list(torch.autograd.grad(out, (q, k, v), dout))


def a1_parity_cases():
    """(a)'s cases, (dtype name, B, S, Sk, heads, head_dim, cq, ck, causal):
    the grid at qwen's 16 heads of 64 (batch ``A1_BATCH``, S in
    ``A1_SEQS``, cq = ck = ``A1_CHUNK``, causal and not, float32 and bf16),
    then in bf16 the shapes the driven bf16 paths give A1 at the full
    configs' chunk (``attn_q_chunk`` 2,048): the main path's 8 x 512 (one
    chunk each way), (b)'s 4 x 4,096 (chunks of 2,048), whisper's 8-row step
    (the 1,500-frame encoder, the 448-token decoder and its cross-attention
    over the frames; whisper-medium's heads are qwen's 16 of 64),
    ``zamba2_seq``'s 8 x 512 at zamba2-7b's 32 heads of 112, and
    ``arctic_serve``'s prefills at arctic-480b's 56 heads of 128 (check
    (a)'s 16 prompts of ``SERVE_PROMPTS[0]``, and a group of two of the
    longest prompts). The last two reach the kernels' head_dim > 64 build
    (NP = 2). Then the published Zamba2's shared blocks (``zamba2-7b-
    published``: 32 heads of 224, the "wide" kernels, scores scaled by
    (224 / 2)^-0.5) at the main path's 8 x 512 and (b)'s 4 x 4,096 in bf16
    and at 1 x 512 in float32. Each case ends with its scale (None: the
    kernels' default 1/sqrt(hd))."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import chunk_sizes

    from repro_torch.models import zamba2 as zamba2_model

    cases = [(name, A1_BATCH, s, s, 16, 64, A1_CHUNK, A1_CHUNK, causal, None)
             for name in ("float32", "bfloat16") for s in A1_SEQS for causal in (True, False)]
    chunk = get_config("qwen1.5-0.5b").attn_q_chunk
    frames = get_config("whisper-medium").num_frames
    zamba, arctic = get_config("zamba2-7b"), get_config("arctic-480b")
    zamba_heads = (zamba.num_heads, zamba.d_model // zamba.num_heads)
    arctic_heads = (arctic.num_heads, arctic.d_model // arctic.num_heads)
    for b, s, sk, heads, causal in (
            (GLOBAL_BATCH, SEQ_LEN, SEQ_LEN, (16, 64), True),
            (LONG_TRAIN_BATCH, LONG_TRAIN_SEQ, LONG_TRAIN_SEQ, (16, 64), True),
            (GLOBAL_BATCH, frames, frames, (16, 64), False),
            (GLOBAL_BATCH, WHISPER_SEQ, WHISPER_SEQ, (16, 64), True),
            (GLOBAL_BATCH, WHISPER_SEQ, frames, (16, 64), False),
            (GLOBAL_BATCH, SEQ_LEN, SEQ_LEN, zamba_heads, True),
            (SERVE_SLOTS, SERVE_PROMPTS[0], SERVE_PROMPTS[0], arctic_heads, True),
            (2, SERVE_PROMPTS[-1], SERVE_PROMPTS[-1], arctic_heads, True)):
        cases.append(("bfloat16", b, s, sk, *heads, *chunk_sizes(s, sk, chunk), causal, None))
    published = get_config("zamba2-7b-published")
    wide = (published.num_heads, published.resolved_head_dim)
    for name, b, s in (("bfloat16", GLOBAL_BATCH, SEQ_LEN),
                       ("bfloat16", LONG_TRAIN_BATCH, LONG_TRAIN_SEQ), ("float32", 1, SEQ_LEN)):
        cases.append((name, b, s, s, *wide, *chunk_sizes(s, s, chunk), True,
                      zamba2_model.scale(published)))
    return cases


def longctx_parity(torch, dev, par):
    """(a) A1 against its plain version on the same card tensors: output and
    q/k/v gradients (the kernel's recomputing backward against the plain
    loop's autograd) at ``a1_parity_cases()``; within ``A1_TOL`` of the
    plain result's largest |entry|. Records the largest absolute difference
    of outputs (forward) and of gradients (backward). For bfloat16 both are
    also held against the plain version in float32 on the same (bf16)
    values, printed: which of the two the bf16 distance comes from."""
    from repro_torch.kernels import attention, ops

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())

    worst, truth = {}, {}
    for name, b, s, sk, heads, hd, cq, ck, causal, scale in a1_parity_cases():
        q, k, v, dout = a1_inputs(torch, dev, b, s, sk, heads, hd, getattr(torch, name))

        def plain(*t):
            return attention.chunked_attention_ref(*t, causal=causal, cq=cq, ck=ck,
                                                   remat_step=False, scale=scale)

        got = a1_grads(torch, lambda *t: ops.chunked_attention(
            *t, causal=causal, cq=cq, ck=ck, scale=scale), q, k, v, dout)
        want = a1_grads(torch, plain, q, k, v, dout)
        torch.cuda.synchronize()
        case = (f"{name}_B{b}_S{s}_Sk{sk}_H{heads}x{hd}_cq{cq}_ck{ck}_"
                f"{'causal' if causal else 'full'}" + ("" if scale is None else f"_scale{scale:.4f}"))
        worst[case] = []
        for i, (a, w) in enumerate(zip(got, want)):
            err = float((a.float() - w.float()).abs().max())
            top = float(w.float().abs().max())
            kernel = A1[min(i, 1)]
            par.err[kernel] = max(par.err[kernel], err)
            par.cases[kernel] += 1
            worst[case].append(err / top)
            if not (err <= A1_TOL[name][min(i, 1)] * top and torch.isfinite(a).all()):
                raise AssertionError(
                    f"A1 {case} {['out', 'dq', 'dk', 'dv'][i]}: kernel vs plain {err:.3g} > "
                    f"{A1_TOL[name][min(i, 1)]} x {top:.3g}")
        if name == "bfloat16":
            exact = a1_grads(torch, plain, *(t.float() for t in (q, k, v, dout)))
            truth[case] = {"kernel": [rel(a, w) for a, w in zip(got, exact)],
                           "plain": [rel(a, w) for a, w in zip(want, exact)]}
            del exact
        del q, k, v, dout, got, want
        torch.cuda.empty_cache()
    log(f"[longctx] (a) A1 vs its plain version on the card (output, dq, dk, "
        f"dv relative to the plain result's largest |entry|, tolerance {A1_TOL}): " + "; ".join(
            f"{k} " + "/".join(f"{e:.2e}" for e in v) for k, v in worst.items()) + f"; {CARD}")
    log("[longctx] (a) bf16 kernel and bf16 plain version, each against the plain version in "
        "float32 on the same values (output, dq, dk, dv): " + "; ".join(
            f"{k} kernel " + "/".join(f"{e:.2e}" for e in v["kernel"]) + " plain "
            + "/".join(f"{e:.2e}" for e in v["plain"]) for k, v in truth.items()))
    return {"vs_plain": worst, "bf16_vs_float32": truth}


def a1_work(b, s, sk, h, hd, causal, itemsize):
    """What one call must do: (forward flops, forward bytes, backward flops,
    backward bytes). Flops count the (query, key) pairs the mask keeps
    (causal: S (S + 1) / 2), 4 hd per pair forward (QK^T and PV), 10 hd
    backward (the scores again, dP, dV, dQ, dK); bytes read each input
    once and write each output once (forward: q, k, v in, out and the
    per-row m and l out; backward: q, k, v, out, dout, m, l in, dq, dk, dv
    out)."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * sk)
    q_bytes, kv_bytes, stats = b * s * h * hd * itemsize, b * sk * h * hd * itemsize, b * h * s * 4
    fwd_bytes = 2 * q_bytes + 2 * kv_bytes + 2 * stats
    bwd_bytes = 3 * q_bytes + 2 * kv_bytes + 2 * stats + q_bytes + 2 * kv_bytes
    return 4 * hd * pairs, fwd_bytes, 10 * hd * pairs, bwd_bytes


A1_KERNEL_PARTS = ("attn_fwd", "attn_bwd_dq", "attn_bwd_dkv")


def a1_kernel_split(kernels):
    """{part: {"ms", "calls"}} of A1's kernels among profiled device events,
    by the name parts ``A1_KERNEL_PARTS`` (the forward, dQ, dK/dV)."""
    split = {}
    for e in kernels:
        part = next((p for p in A1_KERNEL_PARTS if p in e.key), None)
        if part:
            d = split.setdefault(part, {"ms": 0.0, "calls": 0})
            d["ms"] += getattr(e, "self_device_time_total", 0) / 1e3
            d["calls"] += e.count
    return split


def a1_timing(torch, dev, b, s, ck, what, sk=None, heads=16, hd=64, causal=True, cq=None):
    """A1 forward and backward at (B ``b``, S ``s``, Sk ``sk`` (default S),
    ``heads`` heads of ``hd``, chunks (``cq``, ``ck``), cq defaulting to
    ck), bf16, on CUDA events: kernel, plain version (the loop at the same
    chunks), ``scaled_dot_product_attention`` (the library call for the same
    function, timed here and used nowhere in the port), each against the
    bound: the larger of the flops at 989 TFLOP/s (dense bf16) and the
    bytes at the memory rate; and the wrapper's host time a call (10
    launches on the host clock, not waited on). Returns {kernel name:
    numbers}."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels import attention
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16

    sk, cq = sk or s, cq or ck
    q, k, v, dout = a1_inputs(torch, dev, b, s, sk, heads, hd, torch.bfloat16, seed=1)
    out, m, l = attention.attention_forward(q, k, v, causal, ck)
    qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    lib_out = sdpa(qs, ks, vs, is_causal=causal)
    plain_in = [t.detach().requires_grad_() for t in (q, k, v)]
    plain_out = attention.chunked_attention_ref(*plain_in, causal=causal, cq=cq, ck=ck,
                                                remat_step=False)
    runs = {
        "chunked_attention_fwd": (
            lambda: attention.attention_forward(q, k, v, causal, ck),
            lambda: attention.chunked_attention_ref(q, k, v, causal=causal, cq=cq, ck=ck),
            lambda: sdpa(qs.detach(), ks.detach(), vs.detach(), is_causal=causal)),
        "chunked_attention_bwd": (
            lambda: attention.attention_backward(q, k, v, out, dout, m, l, causal),
            lambda: torch.autograd.grad(plain_out, plain_in, dout, retain_graph=True),
            lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dout.transpose(1, 2),
                                        retain_graph=True))}
    fwd_flops, fwd_bytes, bwd_flops, bwd_bytes = a1_work(b, s, sk, heads, hd, causal, 2)
    work = {"chunked_attention_fwd": (fwd_flops, fwd_bytes),
            "chunked_attention_bwd": (bwd_flops, bwd_bytes)}
    shape = (f"{what}: B {b}, S {s}" + (f", Sk {sk}" if sk != s else "") + f", {heads} heads of "
             f"{hd}, bf16, {'causal' if causal else 'not causal'}, cq {cq}, ck {ck}")
    times = {}
    for name, (kernel, plain, library) in runs.items():
        k1 = median_ms(torch, kernel, reps=10, warmup=2)
        p = median_ms(torch, plain, reps=3, warmup=1)
        lib = median_ms(torch, library, reps=10, warmup=2)
        k2 = median_ms(torch, kernel, reps=10, warmup=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # the wrapper's host time: 10 launches, not waited on
        for _ in range(10):
            kernel()
        host_us = (time.perf_counter() - t0) / 10 * 1e6
        torch.cuda.synchronize()
        flops, bytes_ = work[name]
        flops_ms, bytes_ms = flops / PEAK_FLOPS_BF16 * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3
        times[name] = {"ms": min(k1, k2), "ms_runs": [k1, k2], "plain_ms": p,
                       "library_ms": lib, "bound_ms": max(flops_ms, bytes_ms),
                       "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
                       "flops": flops, "bytes": bytes_, "host_us": host_us}
        log(f"[time] {name} ({shape}): kernel {k1:.3f} / {k2:.3f} ms, host {host_us:.1f} us a call "
            f"({flops / (min(k1, k2) * 1e-3) / 1e12:.2f} TFLOP/s, "
            f"{100 * max(flops_ms, bytes_ms) / min(k1, k2):.1f} % of the bound), plain {p:.3f} ms, "
            f"scaled_dot_product_attention {lib:.3f} ms, bound {max(flops_ms, bytes_ms):.4f} ms "
            f"({flops / 1e9:.1f} GFLOP at 989 TFLOP/s {flops_ms:.4f} ms, {bytes_ / 1e6:.1f} MB at "
            f"3.35 TB/s {bytes_ms:.4f} ms); {CARD}")
    del q, k, v, dout, out, m, l, qs, ks, vs, lib_out, plain_in, plain_out
    return times


def longctx_train(torch, dev):
    """(b) qwen1.5-0.5b at full width trained at the reference's train_4k
    length: 3 steps of ``LONG_TRAIN_BATCH`` x 4,096 through ``train_loop``
    with ``fpisa`` and remat "full" (the config's), every count zeroed just
    before and read just after: K1/K2 once per leaf per step, A1 forward
    twice per layer per step (the layer's recompute), backward once. Then
    the step's breakdown, tok/s, the forward+backward's peak memory beside
    the float32 logits' bytes, and A1's share of a profiled
    forward+backward. Returns (launches, numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.kernels import attention
    from repro_torch.launch.train import train_loop

    cfg = get_config("qwen1.5-0.5b")
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt_state, losses = train_loop(
        cfg, steps=STEPS, global_batch=LONG_TRAIN_BATCH, seq_len=LONG_TRAIN_SEQ,
        agg=AggConfig(strategy="fpisa", backend="auto"), device=dev, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    leaves = len(list(model.parameters()))
    launches = k1k2_subset(counts)
    check_fpisa_launches(counts, leaves * STEPS, "longctx")
    launches.update(check_a1_launches(counts, cfg, STEPS, "longctx"))
    launches.update(check_o1_launches(counts, STEPS, "longctx", leaves))
    if not (all(math.isfinite(v) for v in losses)
            and all(torch.isfinite(p).all() for p in model.parameters())):
        raise AssertionError(f"longctx: non-finite loss or parameter ({losses})")
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = LONG_TRAIN_BATCH * LONG_TRAIN_SEQ
    logits_gb = cfg.vocab_size * tokens * 4 / 1e9
    log(f"[longctx] (b) {cfg.name} at full width: {STEPS} steps of {LONG_TRAIN_BATCH} x "
        f"{LONG_TRAIN_SEQ} with fpisa, remat {cfg.remat}, attn_q_chunk {cfg.attn_q_chunk}, in "
        f"{wall:.2f} s (init included), losses {losses}; launches {json.dumps(launches)}; peak "
        f"memory {train_peak:.2f} GiB; float32 logits {cfg.vocab_size} x {tokens} x 4 B = "
        f"{logits_gb:.2f} GB; {CARD}")
    torch.cuda.reset_peak_memory_stats()
    parts = step_breakdown(torch, dev, model, opt_state, "fpisa", seq_len=LONG_TRAIN_SEQ,
                           batch_size=LONG_TRAIN_BATCH)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del opt_state
    torch.cuda.empty_cache()
    batch = training_batch(torch, dev, cfg, LONG_TRAIN_SEQ, LONG_TRAIN_BATCH)
    params = list(model.parameters())
    events = profiled_events(torch, lambda: torch.autograd.grad(model.loss(batch), params))
    share = None
    if events is not None:
        from torch.autograd import DeviceType

        kern = [e for e in events if e.device_type == DeviceType.CUDA]
        busy = sum(getattr(e, "self_device_time_total", 0) for e in kern) / 1e3
        a1 = sum(getattr(e, "self_device_time_total", 0) for e in kern
                 if "attn_fwd" in e.key or "attn_bwd" in e.key) / 1e3
        share = {"kernels_ms": busy, "a1_ms": a1, "a1_kernels": a1_kernel_split(kern)}
    total = sum(parts.values())
    split = "; ".join(f"{k} {v['ms']:.2f} ms over {v['calls']} calls ({v['ms'] / v['calls']:.3f} ms "
                      f"a call)" for k, v in (share or {}).get("a1_kernels", {}).items())
    log(f"[longctx] (b) step, CUDA events: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in parts.items()) + f"; {total:.2f} ms = "
        f"{tokens / total * 1e3:,.0f} tok/s; peak memory of the step {peak:.2f} GiB; profiled "
        f"forward+backward: " + (f"{share['kernels_ms']:.2f} ms of kernels, A1 {share['a1_ms']:.2f}"
                                 f" ms ({100 * share['a1_ms'] / share['kernels_ms']:.1f} %): "
                                 f"{split}" if share and share["kernels_ms"] else "not measured")
        + f"; A1's bf16 kernels' registers a thread and CTAs an SM: " + json.dumps(
            {k: [v["registers"], v["ctas_per_sm"]] for k, v in attention.kernel_info().items()})
        + f"; {CARD}")
    del model
    torch.cuda.empty_cache()
    return launches, {"losses": losses, "step_ms": parts, "tok_s": tokens / total * 1e3,
                      "train_peak_gib": train_peak, "step_peak_gib": peak,
                      "logits_gb": logits_gb, "profile": share}


def longctx_dots(torch, dev):
    """(f) qwen1.5-0.5b at full width, one forward+backward of 4 x 4,096
    under remat "dots" beside "full" (the config's): A1's launches of one
    "dots" forward+backward (path ``longctx_dots``: the forward twice per
    layer, the backward once), then ``remat_timing``'s numbers for each
    (median of 3) and tok/s. Returns (launches, numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build

    cfg = get_config("qwen1.5-0.5b")
    model = build(cfg, device=dev, seed=0)
    batch = training_batch(torch, dev, cfg, LONG_TRAIN_SEQ, LONG_TRAIN_BATCH)
    grads, launches = remat_grads(torch, model, batch, "dots")
    check_remat_a1(launches, cfg, "dots", f"longctx {LONG_TRAIN_BATCH} x {LONG_TRAIN_SEQ}")
    if not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError("longctx dots: a non-finite loss or gradient")
    del grads
    tokens = LONG_TRAIN_BATCH * LONG_TRAIN_SEQ
    res = remat_timing(torch, model, batch, ("full", "dots"), reps=3)
    log(f"[longctx] (f) {cfg.name} forward+backward of {LONG_TRAIN_BATCH} x {LONG_TRAIN_SEQ}: "
        + remat_report(res, tokens) + f"; dots: A1 launches (forward, backward) "
        f"{[launches[k] for k in A1]}; {CARD}")
    del model, batch
    torch.cuda.empty_cache()
    return launches, {"timing": res, "tok_s": {m: tokens / statistics.median(r["ms"]) * 1e3
                                                for m, r in res.items()}}


def longctx_prefill(torch, dev):
    """(c) one 32,768-token qwen row at full width (bf16 weights from a
    seed): ``prefill`` into a decode cache, then 64 greedy ``decode_step``s,
    every count zeroed just before and read just after (A1 once per layer,
    forward only); prefill and decode times, the row's K/V bytes and the
    cache's (a decode cache holds ``DECODE_ROWS`` rows), peak memory. The
    checks: A1 against its plain version at the prefill's attention shape
    (bf16, ``A1_TOL``); on a float32 copy, prefill's last logits against a
    fresh ``forward``'s last position within ``PREFILL_ATOL``. Returns
    (launches, numbers)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_jax, params_to_jax
    from repro_torch.kernels import attention
    from repro_torch.models.registry import build

    cfg = get_config("qwen1.5-0.5b")
    model = build(cfg, device=dev, seed=0)
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, LONG_PREFILL))).to(dev)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    cache = model.init_cache(1, LONG_PREFILL + LONG_DECODE)
    (logits, cache), prefill_s, prefill_dev = timed(torch, lambda: model.prefill(tokens, cache))
    decode_ms = []
    with torch.inference_mode():
        for _ in range(LONG_DECODE):
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            (logits, cache), _, dev_s = timed(torch, lambda: model.decode_step(nxt, cache))
            decode_ms.append(dev_s * 1e3)
            if not torch.isfinite(logits).all():
                raise AssertionError("longctx prefill: non-finite decode logits")
    counts = read_launches()
    launches = a1_subset(counts)
    if {k: counts[k] for k in A1} != {"chunked_attention_fwd": cfg.num_layers,
                                      "chunked_attention_bwd": 0}:
        raise AssertionError(f"prefill_32k: A1 launched {launches}, expected once per layer")
    peak = torch.cuda.max_memory_allocated() / 2**30
    kv = cache.kv.k
    row_bytes = 2 * cfg.num_layers * (LONG_PREFILL + LONG_DECODE) * kv.shape[-2] * kv.shape[-1] \
        * kv.element_size()
    cache_bytes = 2 * kv.numel() * kv.element_size()
    del cache, logits
    torch.cuda.empty_cache()
    log(f"[longctx] (c) {cfg.name} prefill of 1 x {LONG_PREFILL} tokens (attn_q_chunk "
        f"{cfg.attn_q_chunk}): {prefill_dev * 1e3:.1f} ms on CUDA events ({prefill_s:.2f} s host "
        f"wall, {LONG_PREFILL / prefill_dev:,.0f} tok/s), then {LONG_DECODE} greedy decode "
        f"steps: median {statistics.median(decode_ms):.2f} ms a step; A1 launches "
        f"{json.dumps(launches)}; K/V of the row {row_bytes / 1e9:.2f} GB in bf16 (the decode "
        f"cache's {kv.shape[1]} rows {cache_bytes / 1e9:.2f} GB); peak memory {peak:.2f} GiB; "
        f"{CARD}")
    # A1 against its plain version at the prefill's attention shape
    cq, ck = attention.chunk_sizes(LONG_PREFILL, LONG_PREFILL, cfg.attn_q_chunk)
    q, k, v, _ = a1_inputs(torch, dev, 1, LONG_PREFILL, LONG_PREFILL, cfg.num_heads,
                           cfg.resolved_head_dim, torch.bfloat16, seed=2)
    with torch.no_grad():
        got = attention.attention_forward(q, k, v, True, ck)[0]
        want = attention.chunked_attention_ref(q, k, v, causal=True, cq=cq, ck=ck)
    a1_err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    del q, k, v, got, want
    torch.cuda.empty_cache()
    if not a1_err <= A1_TOL["bfloat16"][0]:
        raise AssertionError(f"A1 at 1 x {LONG_PREFILL}: kernel vs plain {a1_err:.3g} relative")
    # the float32 copy: prefill == a fresh forward's last position
    c32 = cfg.with_(param_dtype="float32", activation_dtype="float32")
    m32 = build(c32, device=dev, params=params_from_jax(params_to_jax(model)))
    del model
    with torch.inference_mode():
        last, _ = m32.prefill(tokens, m32.init_cache(1, LONG_PREFILL, rows=1))
        full = m32({"tokens": tokens})[0][:, -1:]
    err = float((last - full).abs().max())
    top = float(full.abs().max())
    del m32, last, full
    torch.cuda.empty_cache()
    if not err <= PREFILL_ATOL:
        raise AssertionError(f"prefill_32k float32: last logits differ from a fresh forward by "
                             f"{err:.3g} (tolerance {PREFILL_ATOL})")
    log(f"[longctx] (c) checks: A1 vs plain at 1 x {LONG_PREFILL} (bf16, ck {ck}) "
        f"{a1_err:.3g} relative (tolerance {A1_TOL['bfloat16'][0]}); float32 copy: prefill's "
        f"last logits == a fresh forward's last position, max |diff| {err:.3g} (tolerance "
        f"{PREFILL_ATOL} absolute, largest |logit| {top:.3g}); {CARD}")
    return launches, {"prefill_ms": prefill_dev * 1e3, "decode_ms": statistics.median(decode_ms),
                      "kv_row_gb": row_bytes / 1e9, "kv_cache_gb": cache_bytes / 1e9,
                      "peak_gib": peak, "a1_vs_plain": a1_err, "prefill_vs_forward": err}


@contextlib.contextmanager
def plain_attention():
    """The models' attention through A1's plain version, on any device
    (the checks' reference; nothing in the port does this)."""
    from repro_torch.kernels import attention, ops

    kernel = ops.chunked_attention
    ops.chunked_attention = lambda q, k, v, **kw: attention.chunked_attention_ref(q, k, v, **kw)
    try:
        yield
    finally:
        ops.chunked_attention = kernel


def longctx_encoder(torch, dev):
    """(d) whisper-medium's encoder at its published size (bf16 weights from
    a seed) over 8 x 1500 seeded frames through A1 (non-causal, one block of
    1500 frames: two passes of 64-key tiles), counts zeroed just before and
    read just after (A1 once per encoder layer); its time. Held to its
    float32 copy: the copy's encoder through A1 against the same encoder
    with the plain attention within ``ENCODER_RTOL`` of the largest |state|,
    and the bf16 encoder's distance from the copy's printed. Returns
    (launches, numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_jax, params_to_jax
    from repro_torch.models.registry import build

    cfg = get_config("whisper-medium")
    model = build(cfg, device=dev, seed=0)
    frames, _ = serve_inputs(torch, dev, cfg, WHISPER_ROWS[0])
    with torch.inference_mode():
        zero_launches()
        enc, _, enc_s = timed(torch, lambda: model.encode(frames))
        launches = a1_subset(read_launches())
        enc_ms = median_ms(torch, lambda: model.encode(frames), reps=3, warmup=0)
    if {k: launches[k] for k in A1} != {"chunked_attention_fwd": cfg.num_encoder_layers,
                                        "chunked_attention_bwd": 0}:
        raise AssertionError(f"whisper encoder: A1 launched {launches}, expected once per layer")
    c32 = cfg.with_(param_dtype="float32", activation_dtype="float32")
    m32 = build(c32, device=dev, params=params_from_jax(params_to_jax(model)))
    del model
    with torch.inference_mode():
        enc32 = m32.encode(frames)
        with plain_attention():
            ref32 = m32.encode(frames)
    top = float(ref32.abs().max())
    err = float((enc32 - ref32).abs().max()) / top
    drift = float((enc.float() - ref32).abs().max()) / top
    del m32, enc, enc32, ref32
    torch.cuda.empty_cache()
    if not err <= ENCODER_RTOL:
        raise AssertionError(f"whisper encoder float32: A1 vs plain attention {err:.3g} > "
                             f"{ENCODER_RTOL} relative")
    rows = WHISPER_ROWS[0]
    log(f"[longctx] (d) {cfg.name} encoder, {rows} x {cfg.num_frames} frames through A1 "
        f"(launches {json.dumps(launches)}): bf16 {enc_ms:.2f} ms on CUDA events "
        f"({rows * cfg.num_frames / enc_ms * 1e3:,.0f} frames/s); float32 copy through A1 vs the "
        f"plain attention {err:.3g} of the largest |state| (tolerance {ENCODER_RTOL}); the bf16 "
        f"encoder is {drift:.3g} of it from the float32 copy; {CARD}")
    return launches, {"encoder_ms": enc_ms, "fp32_a1_vs_plain": err, "bf16_vs_fp32": drift}


# S1 at the cell zamba2_train_4k's shape: zamba2-7b's Mamba2 SSD over 4 x
# 4,096 tokens (B, S, H, P, G, N, chunk); and mamba2-780m's at [models]
# (a)'s 8 x 512 (N 128, one group)
S1_SHAPE = (4, 4096, 112, 64, 2, 64, 256)
S1_PARITY = {"zamba2-7b": S1_SHAPE, "mamba2-780m": (8, 512, 48, 64, 1, 128, 256)}
# S1 against the float64 plain version, of the largest |entry|: the final
# state, ddt, dA, dD (float32) 1e-5; y, dx, dB, dC (bf16) one rounding
S1_TOL = {"y": 2.0 ** -8, "final": 1e-5, "dx": 2.0 ** -8, "ddt": 1e-5, "dA": 1e-5,
          "dB": 2.0 ** -8, "dC": 2.0 ** -8, "dD": 1e-5}


def s1_inputs(torch, dev, shape, seed=0):
    """bf16 x, B and C as views of one (B, S, H P + 2 G N) row, as the
    block's projection split hands them; dt log-uniform over Mamba2's
    initial range [1e-3, 0.1] (the state a chunk carries, and the tiles far
    from the diagonal, weigh in the result); A the model's -[1 .. 16]; D,
    dy and the final state's gradient normal."""
    b, s, h, p, g, n, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    wide = torch.randn(b, s, h * p + 2 * g * n, device=dev, generator=gen).to(torch.bfloat16)
    x = wide[..., :h * p].unflatten(-1, (h, p))
    bm = wide[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cm = wide[..., h * p + g * n:].unflatten(-1, (g, n))
    u = torch.rand(b, s, h, device=dev, generator=gen)
    dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    d = torch.randn(h, device=dev, generator=gen)
    dy = torch.randn(b, s, h, p, device=dev, generator=gen).to(torch.bfloat16)
    dfin = torch.randn(b, h, p, n, device=dev, generator=gen)
    return (x, dt, a, bm, cm, d), dy, dfin


def s1_parity(torch, dev, par):
    """S1 through ``models.mamba2.ssd_chunked`` and autograd against the
    plain version in float64 on the same inputs (``ssd_float64_ref``) at
    ``S1_PARITY``'s shapes: y, the final state and the gradients of sum(y
    dy) + sum(final dfinal) within ``S1_TOL``; the launches of each call,
    counted from zero, one forward and one backward. Records the largest
    |difference| in ``par``. Returns {model: {output: difference over the
    largest |entry|}}."""
    from repro_torch.kernels import ssd
    from repro_torch.models import mamba2

    worst = {}
    for model, shape in S1_PARITY.items():
        args, dy, dfin = s1_inputs(torch, dev, shape, seed=1)
        chunk = shape[-1]
        want = ssd.ssd_float64_ref(*args, chunk, dy, dfin)
        want = (want[0], want[1], *want[2])
        leaves = [t.detach().requires_grad_() for t in args]
        zero_launches()
        y, fin = mamba2.ssd_chunked(*leaves, chunk)
        grads = torch.autograd.grad((y.float() * dy.float()).sum() + (fin * dfin).sum(), leaves)
        torch.cuda.synchronize()
        launches = s1_subset(read_launches())
        if launches != {"ssd_forward": 1, "ssd_backward": 1}:
            raise AssertionError(f"[s1] {model}: S1 launched {launches}, expected one of each")
        worst[model] = {}
        for i, (name, got, w) in enumerate(zip(S1_TOL, (y, fin, *grads), want)):
            err = float((got.detach().double() - w).abs().max())
            top = float(w.abs().max())
            kernel = S1[min(i // 2, 1)]
            par.err[kernel] = max(par.err[kernel], err)
            par.cases[kernel] += 1
            worst[model][name] = err / top
            if not err <= S1_TOL[name] * top:
                raise AssertionError(f"[s1] {model} {shape} {name}: S1 vs the float64 plain "
                                     f"version {err:.3g} > {S1_TOL[name]} x {top:.3g}")
        del args, dy, dfin, want, leaves, y, fin, grads
        torch.cuda.empty_cache()
    log(f"[s1] S1 vs the plain version in float64 (B, S, H, P, G, N, chunk {S1_PARITY}; bf16, "
        f"dt in [1e-3, 0.1]), difference over the largest |entry| (limits {S1_TOL}): "
        f"{json.dumps(worst)}; one forward and one backward launch a call; {CARD}")
    return worst


def s1_line(torch, dev, par):
    """The ``[s1]`` lines: ``s1_parity``; then S1's forward and backward
    (CUDA events, median of 25) at S1_SHAPE in bf16 beside their bound (the
    benchmark's ``metrics/ssd_roofline.zamba2.py`` formula at the cell's
    configuration), the plain version's (float32 einsums on the same bf16
    inputs, median of 3; its backward is autograd's, its forward's time
    taken out), and each kernel's registers and CTAs an SM
    (``kernel_info()``). No PyTorch call computes the SSD, so there is no
    library time. Returns the kernels line's numbers, {"ssd_forward": ...,
    "ssd_backward": ...}."""
    from fpisa_bench import counts, counts_zamba2, spec
    from repro_torch.kernels import ssd

    s1_parity(torch, dev, par)
    b, s, h, p, g, n, chunk = S1_SHAPE
    (x, dt, a, bm, cm, d), dy, _ = s1_inputs(torch, dev, S1_SHAPE)
    args = (x, dt, a, bm, cm, d)
    y, fin, states = ssd.ssd_forward(*args, chunk)
    fwd = median_ms(torch, lambda: ssd.ssd_forward(*args, chunk))
    bwd = median_ms(torch, lambda: ssd.ssd_backward(*args, chunk, states, dy))
    plain_fwd = median_ms(torch, lambda: ssd.ssd_chunked_ref(*args, chunk), reps=3, warmup=1)
    leaves = [t.detach().requires_grad_() for t in args]

    def plain_fwd_bwd():
        yr, _ = ssd.ssd_chunked_ref(*leaves, chunk)
        torch.autograd.grad(yr, leaves, dy)

    plain_bwd = median_ms(torch, plain_fwd_bwd, reps=3, warmup=1) - plain_fwd
    cell = spec.Cell("zamba2_train_4k")
    assert (cell.traffic["batch"], cell.traffic["seq"]) == (b, s)
    bound_f, bound_b = (1e3 * t for t in spec.metric_reader("ssd_roofline.zamba2")
                        .call_bounds_s(cell.config, b, s))
    flops_ms = 1e3 * counts_zamba2.ssd_flops_per_token(cell.config) * b * s \
        / counts.PEAK_FLOPS_BF16
    info = {k: (v["registers"], v["ctas_per_sm"], v["smem_bytes"], v["local_bytes"])
            for k, v in ssd.kernel_info(n, chunk).items()}
    line = {"forward_ms": fwd, "backward_ms": bwd, "bound_forward_ms": bound_f,
            "bound_backward_ms": bound_b, "plain_forward_ms": plain_fwd,
            "plain_backward_ms": plain_bwd, "library_ms": None,
            "kernels (registers, ctas_per_sm, smem_bytes, local_bytes)": info}
    log(f"[s1] zamba2-7b's SSD, B {b}, S {s}, H {h}, P {p}, G {g}, N {n}, chunk {chunk}, bf16: "
        f"{json.dumps(line)}; {CARD}")
    del x, bm, cm, dt, dy, y, fin, states, leaves, args
    return {name: {"ms": ms, "plain_ms": plain, "bound_ms": bound, "library_ms": None,
                   "bound_by": "operations" if ops_ms >= bound else "bytes"}
            for name, ms, plain, bound, ops_ms in (
                ("ssd_forward", fwd, plain_fwd, bound_f, flops_ms),
                ("ssd_backward", bwd, plain_bwd, bound_b, 2 * flops_ms))}


# O1 at the training cells' trees: their leaves' shapes from the benchmark's
# configurations, bf16 as the cells train them
O1_CELLS = ("qwen_train_4k", "zamba2_train_4k")
# the clip inactive: no gradient's norm reaches it, the scale is 1 on both routes
O1_NO_CLIP = 1e9


def o1_tree(torch, dev, cell_name, seed):
    """(params, grads, state, optimizer settings) at ``cell_name``'s tree:
    bf16 params and gradients, float32 moments, from ``seed`` on the card."""
    from fpisa_bench import spec
    from repro_torch.optim import optimizers

    cell = spec.Cell(cell_name)
    shapes = [tuple(s) for _, s, _ in spec.reference(cell.config_name).param_spec(cell.config)]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype).mul_(std)

    params = [normal(s, 0.02, torch.bfloat16) for s in shapes]
    grads = [normal(s, 1e-4, torch.bfloat16) for s in shapes]
    state = optimizers.OptState(step=0, m=[normal(s, 1e-5) for s in shapes],
                                v=[normal(s, 1e-5).square_() for s in shapes])
    return params, grads, state, cell.traffic["optimizer"]


def o1_line(torch, dev, par):
    """The ``[o1]`` lines, one a training cell's tree (``O1_CELLS``): one
    step of ``optimizers.update`` (O1, two launches) against the eager
    route (``update_eager``) on copies of the same tensors with the clip
    inactive: p, m, v and lr bit for bit, failing on a miss; with the clip
    active, the two grad_norms' relative difference. Then O1's time (CUDA
    events, median of 10; its norm and update kernels each, median of 25)
    beside its bound (24 bytes a bf16 parameter at 3.35 TB/s: the norm
    reads g, the update reads g, p, m, v and writes p, m, v), the eager
    route's (median of 3; its clip alone, ``_clip``, and its update alone,
    ``_apply`` on the clipped gradients, the plain times of the kernels
    line's norm and update) and the host's time to
    issue each (host clock, no synchronize, median of 5: the eager route
    waits on its scalars' copies); the kernels' registers and CTAs an SM.
    Returns the kernels line's numbers at qwen's tree (the main path's)."""
    from repro_torch.kernels import adamw
    from repro_torch.optim import optimizers

    out = {}
    for cell_name in O1_CELLS:
        params, grads, state, opt = o1_tree(torch, dev, cell_name, seed=34)
        cfg = optimizers.OptConfig(name="adamw", **{**opt, "grad_clip": O1_NO_CLIP})
        o1_p = [p.clone() for p in params]
        o1_s = state._replace(m=[t.clone() for t in state.m], v=[t.clone() for t in state.v])
        zero_launches()
        o1_s, o1_met = optimizers.update(o1_p, grads, o1_s, cfg)
        launches = o1_subset(read_launches())
        eager_s, eager_met = optimizers.update_eager(params, grads, state, cfg)
        torch.cuda.synchronize()
        if launches != {"adamw_norm": 1, "adamw_update": 1}:
            raise AssertionError(f"[o1] {cell_name}: O1 launched {launches}, expected 1 and 1")
        ints = {2: torch.int16, 4: torch.int32}
        for i, (a, b) in enumerate(zip(o1_p + o1_s.m + o1_s.v + [o1_met["lr"]],
                                       params + eager_s.m + eager_s.v + [eager_met["lr"]])):
            if torch.equal(a.view(ints[a.element_size()]), b.view(ints[b.element_size()])):
                par.cases["adamw_update"] += 1
            else:
                par.check("adamw_update", a, b, f"{cell_name} tensor {i}")  # raises
        del o1_p, o1_s
        torch.cuda.empty_cache()
        clip = optimizers.OptConfig(name="adamw", **opt)
        state = eager_s
        _, got = optimizers.update(params, grads, state, clip)
        _, want = optimizers.update_eager(params, grads, state, clip)
        rel = abs(float(got["grad_norm"]) - float(want["grad_norm"])) / float(want["grad_norm"])
        par.err["adamw_norm"] = max(par.err["adamw_norm"], rel)
        par.cases["adamw_norm"] += 1
        if not rel <= 1e-6:
            raise AssertionError(f"[o1] {cell_name}: grad_norm {float(got['grad_norm'])} vs the "
                                 f"eager route's {float(want['grad_norm'])}, {rel:.3g} apart")

        n = sum(p.numel() for p in params)
        tables = adamw._tables(params, grads, state.m, state.v)
        partials = torch.empty(len(tables) * adamw.NORM_CTAS, dtype=torch.float64, device=dev)
        gnorm, lr = torch.empty((), device=dev), torch.empty((), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the eager update's own inputs: the clipped float32 gradients and the step's scalars
        clipped, _ = optimizers._clip(grads, clip.grad_clip)
        step_f = optimizers._f32(1, grads[0])
        lr_f = optimizers._schedule(clip, step_f)
        t = {"o1": median_ms(torch, lambda: optimizers.update(params, grads, state, clip), reps=10),
             "norm": median_ms(torch, lambda: adamw.adamw_norm(tables, partials, stream)),
             "update": median_ms(torch, lambda: adamw.adamw_update(tables, partials, gnorm, lr,
                                                                   1, clip, stream)),
             "eager": median_ms(torch, lambda: optimizers.update_eager(params, grads, state,
                                                                       clip), reps=3, warmup=1),
             "eager_clip": median_ms(torch, lambda: optimizers._clip(grads, clip.grad_clip),
                                     reps=3, warmup=1),
             "eager_update": median_ms(torch, lambda: optimizers._apply(
                 params, clipped, state, clip, step_f, lr_f), reps=3, warmup=1)}
        host = {}
        for route in ("update", "update_eager"):
            issue = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                getattr(optimizers, route)(params, grads, state, clip)
                issue.append(1e3 * (time.perf_counter() - t0))
            host[route] = statistics.median(issue)
        torch.cuda.synchronize()
        bound = {"norm": 2 * n / HBM_BYTES_PER_S * 1e3, "update": 22 * n / HBM_BYTES_PER_S * 1e3}
        line = {"parameters": n, "leaves": len(params), "o1_ms": t["o1"], "norm_ms": t["norm"],
                "update_ms": t["update"], "bound_ms": bound["norm"] + bound["update"],
                "bound_norm_ms": bound["norm"], "bound_update_ms": bound["update"],
                "eager_ms": t["eager"], "eager_clip_ms": t["eager_clip"],
                "eager_update_ms": t["eager_update"],
                "host_issue_ms": {"o1": host["update"], "eager": host["update_eager"]},
                "grad_norm_rel_diff": rel, "launches": launches,
                "kernels (registers, ctas_per_sm, local_bytes)": {
                    k: (v["registers"], v["ctas_per_sm"], v["local_bytes"])
                    for k, v in adamw.kernel_info().items()}}
        log(f"[o1] {cell_name}'s tree, clip inactive: O1 == the eager route bit for bit (p, m, "
            f"v, lr); {json.dumps(line)}; {CARD}")
        if cell_name == O1_CELLS[0]:
            out = {"adamw_norm": {"ms": t["norm"], "plain_ms": t["eager_clip"],
                                  "bound_ms": bound["norm"], "bound_by": "bytes",
                                  "library_ms": None},
                   "adamw_update": {"ms": t["update"], "plain_ms": t["eager_update"],
                                    "bound_ms": bound["update"], "bound_by": "bytes",
                                    "library_ms": None}}
        del params, grads, state, eager_s, tables, partials, clipped
        torch.cuda.empty_cache()
    return out


def longctx_path(torch, dev, par):
    """The tenth slice's paths (``[longctx]`` lines): (a) A1 against its
    plain version, (b) qwen trained at 4,096 tokens (path ``longctx``), (f)
    its forward+backward under remat "dots" and "full" (path
    ``longctx_dots``), (c)
    a 32,768-token prefill and 64 decode steps (path ``prefill_32k``), (d)
    whisper's encoder (path ``whisper_encoder``); then A1's times at (b)'s
    shape (the kernels line), (a)'s, the main path's, whisper's three and
    one head_dim-128 shape. Returns ({path: launches}, {kernel: times})."""
    t0 = time.perf_counter()
    parity = longctx_parity(torch, dev, par)
    torch.cuda.empty_cache()
    paths, numbers = {}, {"parity": parity}
    paths["longctx"], numbers["train"] = longctx_train(torch, dev)
    paths["longctx_dots"], numbers["dots"] = longctx_dots(torch, dev)
    paths["prefill_32k"], numbers["prefill"] = longctx_prefill(torch, dev)
    paths["whisper_encoder"], numbers["encoder"] = longctx_encoder(torch, dev)
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import chunk_sizes

    ck = chunk_sizes(LONG_TRAIN_SEQ, LONG_TRAIN_SEQ, get_config("qwen1.5-0.5b").attn_q_chunk)[1]
    times = a1_timing(torch, dev, LONG_TRAIN_BATCH, LONG_TRAIN_SEQ, ck, "(b)'s shape")
    torch.cuda.empty_cache()
    numbers["a1_at_train_4k_cq32"] = a1_timing(torch, dev, A1_BATCH, 4096, A1_CHUNK,
                                               "(a)'s shape")
    torch.cuda.empty_cache()
    # (e): at the main path's 8 x 512 one chunk is the whole row, and the plain
    # version is the one-block branch, the (S, S) softmax A1 replaced
    numbers["a1_at_main_8x512"] = a1_timing(torch, dev, GLOBAL_BATCH, SEQ_LEN, SEQ_LEN,
                                            "(e), the main path's shape")
    torch.cuda.empty_cache()
    # whisper's three attention shapes (its step, [encdec] (a)), and one
    # head_dim-128 shape (arctic's, internlm2's, deepseek's, llava's heads)
    # over two chunks: the kernels' second instantiation (NP = 2)
    frames = get_config("whisper-medium").num_frames
    for key, what, s, sk, causal in (
            ("a1_at_whisper_encoder", "whisper's encoder", frames, frames, False),
            ("a1_at_whisper_decoder", "whisper's decoder", WHISPER_SEQ, WHISPER_SEQ, True),
            ("a1_at_whisper_cross", "whisper's cross-attention", WHISPER_SEQ, frames, False)):
        wcq, wck = chunk_sizes(s, sk, get_config("whisper-medium").attn_q_chunk)
        numbers[key] = a1_timing(torch, dev, GLOBAL_BATCH, s, wck, what, sk=sk, causal=causal,
                                 cq=wcq)
        torch.cuda.empty_cache()
    numbers["a1_at_hd128"] = a1_timing(torch, dev, A1_BATCH, LONG_TRAIN_SEQ, ck,
                                       "head_dim 128", hd=128)
    torch.cuda.empty_cache()
    log(f"[longctx] the group took {time.perf_counter() - t0:.1f} s; {CARD}")
    log(json.dumps({"longctx": numbers}))
    return paths, times


def diagnose(torch, run, what):
    """Where an untraced ``run()`` (an aggregation of the gradients, a
    forward+backward) spends its time: the host's issue time (the host
    clock around the call, no synchronize) against its CUDA-event time,
    median of 5; the caching allocator's new segments (cudaMalloc) over
    those 5 runs; and, from ``torch.profiler`` over one more run, the
    device's kernel time by name and the calls to cudaMalloc / cudaFree.
    Issue time near the event time means the host sets the pace and the
    card waits."""
    from torch.autograd import DeviceType

    run()
    torch.cuda.synchronize()
    segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    issue, device = issue_vs_device(torch, run)
    segments = torch.cuda.memory_stats().get("segment.all.allocated", 0) - segments
    head = (f"[diagnose] {what}: host issue {issue:.2f} ms, CUDA events "
            f"{device:.2f} ms (median of 5); {segments} new allocator "
            f"segments in those 5 runs; profiled run: kernel time ")
    events = profiled_events(torch, run)
    if events is None:
        log(head + "not measured (torch.profiler failed)")
        return

    def device_us(e):
        return getattr(e, "self_device_time_total", 0)

    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(device_us(e) for e in kernels) / 1e3
    mallocs = sum(e.count for e in events if e.key in ("cudaMalloc", "cudaFree"))
    top = sorted(kernels, key=lambda e: -device_us(e))[:6]
    log(head + (f"{busy:.2f} ms, {mallocs} cudaMalloc/cudaFree calls; top kernels: " + "; ".join(
        f"{e.key[:60]} x{e.count} {device_us(e) / 1e3:.2f} ms" for e in top)
        if busy else "not measured (the profiler recorded no device time)"))


# device-op names of the aggregation's kernels in a profile (csrc/fpisa_fused.cu)
AGG_KERNELS = {"block_max_kernel": "K1 exponent", "encode_wire_kernel": "K1 wire",
               "decode_kernel": "K2", "nccl": "NCCL"}
SEQ_KERNELS = {"accum_kernel": "K6", "accum_edge_kernel": "K6", "nccl": "NCCL"}


def aggregation_kernels(torch, run, what, kinds=AGG_KERNELS):
    """The device ops of one ``run()`` of an aggregation on the cuda
    backend, from torch.profiler, by kind (``kinds``: a kernel name's
    substring -> its kind): for ``fpisa`` K1's exponent and wire modes, K2
    and NCCL, for ``fpisa_seq`` (``SEQ_KERNELS``) K6 and NCCL; and anything
    else (an eager shift, cast, fold or copy). Raises if anything else ran;
    "not measured" when the profiler recorded no device op. Returns the
    counts by kind."""
    from torch.autograd import DeviceType

    events = profiled_events(torch, run) or []
    # the port's spans are record_function ranges, which the profiler also
    # draws on the device row (user annotations, not work on the card)
    ranges = {e.key for e in events if getattr(e, "is_user_annotation", False)}
    device_ops = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges]
    if not device_ops:
        log(f"[diagnose] {what}: device ops by kind not measured (the profiler recorded none)")
        return None
    names, other = kinds, {}
    kinds = dict.fromkeys(names.values(), 0)
    for e in device_ops:
        kind = next((v for k, v in names.items() if k in e.key), None)
        if kind is None:
            other[e.key[:90]] = other.get(e.key[:90], 0) + e.count
        else:
            kinds[kind] += e.count
    log(f"[diagnose] {what}: device ops of one run by kind {json.dumps(kinds)}, other "
        f"{json.dumps(other)}")
    if other:
        raise AssertionError(f"{what}: device ops other than {sorted(set(names.values()))} "
                             f"ran between the kernels and the collectives: {other}")
    return kinds


def check_grads_cuda_equals_plain(torch, dev, model, strategy, seq_len=SEQ_LEN):
    """On the trained full-width model's gradients (of the batch
    ``train_loop`` feeds, ``training_batch``), the cuda aggregation of
    ``strategy`` equals the plain one bit for bit, all finite."""
    from repro_torch.core.agg import AggConfig, Aggregator

    batch = training_batch(torch, dev, model.cfg, seq_len)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(model.loss(batch), params)
    kern, plain = (Aggregator(AggConfig(strategy=strategy, backend=b))
                   for b in ("cuda", "torch"))
    for name, g in zip(names, grads):
        a, b = kern.allreduce(g), plain.allreduce(g)
        if not (torch.equal(a.view(torch.int16), b.view(torch.int16))
                and torch.isfinite(a).all()):
            raise AssertionError(f"{strategy}: aggregated gradient {name}: cuda != torch "
                                 f"backend")
    log(f"[check] {strategy}, {model.cfg.name} full-width gradients ({len(names)} leaves, "
        f"{sorted({str(g.dtype) for g in grads})}): cuda aggregation bit-equal to the plain "
        f"aggregation, all finite")
    if strategy == "fpisa_seq":  # K6's leaf mode and the all-gather, nothing between
        kern.allreduce_tree(list(grads))
        aggregation_kernels(torch, lambda: kern.allreduce_tree(list(grads)),
                            f"fpisa_seq aggregation of {model.cfg.name}'s gradients",
                            SEQ_KERNELS)


def check_against_plain(torch, dev, model):
    """Right answers by the repo's own means: on the trained full-width
    model's gradients, the cuda aggregation equals the plain one bit for
    bit; on the smoke config, training through the kernels and through the
    plain versions gives the same losses."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.agg import AggConfig
    from repro_torch.launch.train import train_loop

    from repro_torch.core.agg import Aggregator

    check_grads_cuda_equals_plain(torch, dev, model, "fpisa")
    batch = training_batch(torch, dev, model.cfg)
    grads = list(torch.autograd.grad(model.loss(batch), list(model.parameters())))
    aggregator = Aggregator(AggConfig(backend="cuda"))
    aggregation_kernels(torch, lambda: aggregator.allreduce_tree(grads),
                        f"per-leaf aggregation of {model.cfg.name}'s {len(grads)} gradient leaves")
    del grads
    smoke = get_smoke_config("qwen1.5-0.5b")
    runs = {b: train_loop(smoke, steps=STEPS, global_batch=4, seq_len=64, device=dev,
                          agg=AggConfig(backend=b), log_every=STEPS)[2]
            for b in ("cuda", "torch")}
    if max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"], runs["torch"])) > 1e-6:
        raise AssertionError(f"smoke losses differ between backends: {runs}")
    log(f"[check] smoke losses, cuda vs plain aggregation (rtol 1e-6): {runs}")


def copy_ms(torch, dev, bytes_per_leaf):
    """A ``copy_`` that moves the given bytes per leaf (half read, half
    written): the bandwidth this card reaches on the same traffic."""
    bufs = [(torch.empty(n // 2, dtype=torch.uint8, device=dev),
             torch.empty(n // 2, dtype=torch.uint8, device=dev)) for n in bytes_per_leaf]
    for d, s in bufs:
        s.zero_()
    return median_ms(torch, lambda: [d.copy_(s) for d, s in bufs])


def time_kernel(torch, name, kernel, plain, bytes_, ops_, copy, what, plain_reps=20):
    """kernel, plain, kernel on CUDA events (drift shows), against the
    bound: bytes over the memory rate, integer operations over the issue
    rate, whichever is larger (the operations at the INT32 pipe's rate are
    logged beside it)."""
    k1 = median_ms(torch, kernel)
    p = median_ms(torch, plain, reps=plain_reps, warmup=1)
    k2 = median_ms(torch, kernel)
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_ / PEAK_INT_OPS_PER_S * 1e3
    pipe_ms = ops_ / INT32_PIPE_OPS_PER_S * 1e3
    out = {"ms": min(k1, k2), "ms_runs": [k1, k2], "plain_ms": p,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes_ms": bytes_ms, "ops_ms": ops_ms, "int32_pipe_ms": pipe_ms, "copy_ms": copy}
    log(f"[time] {name}: {what}: kernel {k1:.4f} / {k2:.4f} ms, plain {p:.3f} ms, bound "
        f"{out['bound_ms']:.4f} ms (bytes {bytes_ms:.4f}, {ops_ / 1e9:.3f} G int ops at the "
        f"issue rate {ops_ms:.4f}, at the INT32 pipe's rate {pipe_ms:.4f}), copy_ of "
        f"the same bytes {copy:.4f} ms; {bytes_ / (min(k1, k2) * 1e-3) / 1e12:.3f} TB/s")
    return out


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


def step_leaves(torch, dev, leaf_sizes, seed=0):
    """The main path's gradient leaves as (R, 256) fp32 planes, finite."""
    rows = [-(-n // 256) for n in leaf_sizes]
    xs = [sample(torch, (r, 256), "fp32", seed + i, dev) for i, r in enumerate(rows)]
    return [torch.nan_to_num(x, posinf=1.0, neginf=-1.0) for x in xs]


def timing(torch, dev, leaf_sizes):
    """K1 and K2 at the main path's shapes (the 14 leaves of one step as
    (1, R, 256) bf16 stacks, the fp32 format, the 32-bit wire, preshift 0),
    each against its byte bound, its plain version and a ``copy_`` of the
    same bytes: K1 as the path runs it (exponent mode, then wire mode), each
    mode alone, the local mode at fp32 leaves (the TPU kernel's function);
    K2 into the leaves' bf16 and into the format's fp32. Then one step's
    aggregation passes with the collectives left out: the eager-glue
    composition (the staging cast, the local mode, the residual shift, K2 in
    fp32 and the cast back, as the cuda backend ran before the modes)
    against the modes', host issue against CUDA events. Then the largest
    leaf alone. Returns {kernel: times}, with ``ms_by_mode``."""
    from repro_torch.core import fpisa
    from repro_torch.core import numerics as nx
    from repro_torch.kernels import ops, ref

    fmt = fpisa.FP32
    x32 = step_leaves(torch, dev, leaf_sizes)
    xs = [x.to(torch.bfloat16)[None] for x in x32]  # the main path's bf16 leaves
    bmaxs = [ops.block_max(x, "fp32") for x in xs]
    planes = [ops.encode_wire(x, b, 0, 32, "fp32") for x, b in zip(xs, bmaxs)]
    rows = sum(x.shape[1] for x in xs)
    elems = rows * 256
    what = f"one step = {len(xs)} leaves, {rows} rows x 256 bf16, fp32 format, 32-bit wire"

    def timed_mode(name, kernel, plain, per_elem, ops_per_elem, label, reps=20):
        bytes_ = elems * per_elem + rows * 4
        return time_kernel(torch, name, kernel, plain, bytes_, elems * ops_per_elem,
                           copy_ms(torch, dev, [bytes_]), label, plain_reps=reps)

    k1 = {
        "exponent": timed_mode(
            "fused_encode_align", lambda: [ops.block_max(x, "fp32") for x in xs],
            lambda: [ref.block_max_ref(x, fmt) for x in xs], 2, OPS_PER_ELEM["block_max"],
            f"exponent mode, {what}"),
        "wire": timed_mode(
            "fused_encode_align",
            lambda: [ops.encode_wire(x, b, 0, 32, "fp32") for x, b in zip(xs, bmaxs)],
            lambda: [ref.encode_wire_ref(x, b, 0, 32, fmt) for x, b in zip(xs, bmaxs)], 6,
            OPS_PER_ELEM["encode_wire"], f"wire mode, {what}", reps=5),
        "local": timed_mode(
            "fused_encode_align", lambda: [ops.encode_align(x, "fp32") for x in x32],
            lambda: [ref.fused_encode_align_ref(x, fmt) for x in x32], 8,
            OPS_PER_ELEM["fused_encode_align"],
            f"local mode, one step = {len(x32)} leaves, {rows} rows x 256 fp32", reps=5),
    }
    # K1 as the path runs it: both modes, 8 bytes an element and 8 a row
    pair_bytes = elems * 8 + rows * 8
    out = {"fused_encode_align": time_kernel(
        torch, "fused_encode_align",
        lambda: [ops.encode_wire(x, ops.block_max(x, "fp32"), 0, 32, "fp32") for x in xs],
        lambda: [ref.encode_wire_ref(x, ref.block_max_ref(x, fmt), 0, 32, fmt) for x in xs],
        pair_bytes, elems * (OPS_PER_ELEM["block_max"] + OPS_PER_ELEM["encode_wire"]),
        copy_ms(torch, dev, [pair_bytes]), f"exponent + wire mode, {what}", plain_reps=5)}
    out["fused_encode_align"]["ms_by_mode"] = k1
    k2 = {
        "leaf": timed_mode(
            "fused_decode",
            lambda: [ops.decode_fused(m, b, 0, "fp32", torch.bfloat16) for m, b in zip(planes, bmaxs)],
            lambda: [ref.fused_decode_ref(m, b, 0, fmt, torch.bfloat16)
                     for m, b in zip(planes, bmaxs)], 6, OPS_PER_ELEM["decode_leaf"],
            f"K2 into bf16, {what}", reps=5),
        "format": timed_mode(
            "fused_decode", lambda: [ops.decode_fused(m, b, 0, "fp32") for m, b in zip(planes, bmaxs)],
            lambda: [ref.fused_decode_ref(m, b, 0, fmt) for m, b in zip(planes, bmaxs)], 8,
            OPS_PER_ELEM["fused_decode"], f"K2 into fp32, {what}", reps=5),
    }
    out["fused_decode"] = dict(k2["leaf"], ms_by_mode=k2)

    def glue():  # the cuda backend's passes before the modes, collectives left out
        for x in xs:
            man, b = ops.encode_align(fpisa.to_packed(x[0], "fp32"), "fp32")
            man = nx.arshift(man, (b.clone() - b)[:, None] + 0)
            ops.decode_fused(man, b, 0, "fp32").to(torch.bfloat16)

    def modes():
        for x in xs:
            b = ops.block_max(x, "fp32")
            ops.decode_fused(ops.encode_wire(x, b, 0, 32, "fp32"), b, 0, "fp32", torch.bfloat16)

    passes = {}
    for name, fn in (("glue", glue), ("modes", modes), ("glue", glue), ("modes", modes)):
        fn()
        torch.cuda.synchronize()
        passes.setdefault(name, []).append(issue_vs_device(torch, fn))
    log(f"[time] one step's aggregation passes without the collectives, {what}: eager-glue "
        f"composition (36 B an element, floor {elems * 36 / HBM_BYTES_PER_S * 1e3:.4f} ms) host "
        f"issue / CUDA events " + ", ".join(f"{i:.3f} / {d:.3f}" for i, d in passes["glue"])
        + f" ms; the modes (14 B an element, floor {elems * 14 / HBM_BYTES_PER_S * 1e3:.4f} ms) "
        + ", ".join(f"{i:.3f} / {d:.3f}" for i, d in passes["modes"]) + f" ms; {CARD}")
    out["passes"] = passes
    # the largest leaf alone (the embedding, 607,744 rows)
    big = max(range(len(xs)), key=lambda i: xs[i].shape[1])
    x, b, m = xs[big], bmaxs[big], planes[big]
    d = torch.empty_like(m)
    for name, fn, pfn, per_elem in (
            ("exponent mode", lambda: ops.block_max(x, "fp32"),
             lambda: ref.block_max_ref(x, fmt), 2),
            ("wire mode", lambda: ops.encode_wire(x, b, 0, 32, "fp32"),
             lambda: ref.encode_wire_ref(x, b, 0, 32, fmt), 6),
            ("K2 into bf16", lambda: ops.decode_fused(m, b, 0, "fp32", torch.bfloat16),
             lambda: ref.fused_decode_ref(m, b, 0, fmt, torch.bfloat16), 6)):
        log(f"[time] {name}: largest leaf {x.shape[1]} x 256 bf16: kernel "
            f"{median_ms(torch, fn):.4f} ms, plain {median_ms(torch, pfn, reps=5):.3f} ms, "
            f"bound {x.numel() * per_elem / HBM_BYTES_PER_S * 1e3:.4f} ms, copy_ of an int32 "
            f"plane {median_ms(torch, lambda: d.copy_(m)):.4f} ms; {CARD}")
    return out


def two_pass_pipeline(torch, dev, leaf_sizes, par):
    """decode(align(extract(x), p), p) over the main path's 14 leaves at
    preshift p = 0 and 2, with K3, K4 and K5's launch counts zeroed just
    before and read just after; it must equal the fused
    decode_fused(arshift(encode_align(x), p), p) bit for bit. Then K3, K4
    and K5 are timed at those shapes (p = 0). Returns (launches, times)."""
    from repro_torch.core import fpisa
    from repro_torch.core import numerics as nx
    from repro_torch.kernels import ops, ref

    xs = step_leaves(torch, dev, leaf_sizes)
    preshifts = (0, 2)
    for fn in (ops.extract, ops.align, ops.decode):
        fn.launches = 0
    planes = [ops.extract(x, "fp32") for x in xs]
    aligned = {p: [ops.align(e, m, b, p) for e, m, b in planes] for p in preshifts}
    two_pass = {p: [ops.decode(a, b, p, "fp32") for a, (_, _, b) in zip(aligned[p], planes)]
                for p in preshifts}
    torch.cuda.synchronize()
    launches = {"fpisa_extract": ops.extract.launches, "fpisa_align": ops.align.launches,
                "fpisa_decode": ops.decode.launches}
    log(json.dumps({"two_pass_launches": launches, "leaves": len(xs),
                    "preshifts": list(preshifts)}))
    want = {"fpisa_extract": len(xs), "fpisa_align": len(xs) * len(preshifts),
            "fpisa_decode": len(xs) * len(preshifts)}
    if launches != want:
        raise AssertionError(f"two-pass pipeline: expected {want} launches, got {launches}")
    for i, (x, (_, _, b)) in enumerate(zip(xs, planes)):
        man, bmax = ops.encode_align(x, "fp32")
        if not torch.equal(b, bmax):
            raise AssertionError("two-pass block exponents differ from the fused encode_align")
        for p in preshifts:
            fused = nx.arshift(man, p)  # the residual shift
            if not torch.equal(aligned[p][i], fused):
                raise AssertionError(f"two-pass align differs from the fused encode_align "
                                     f"at preshift {p}")
            par.check("fpisa_decode", two_pass[p][i], ops.decode_fused(fused, bmax, p, "fp32"),
                      f"two-pass vs fused, leaf {tuple(x.shape)}, preshift {p}")
        del man, bmax, fused
    aligned = aligned[0]
    del two_pass
    log(f"[two-pass] decode(align(extract(x), p), p) bit-equal to "
        f"decode_fused(arshift(encode_align(x), p), p) on the {len(xs)} leaves of one step, "
        f"p in {preshifts}")
    fmt = fpisa.FP32
    total_rows = sum(x.shape[0] for x in xs)
    elems = total_rows * 256
    what = f"one step = {len(xs)} leaves, {total_rows} rows x 256 fp32"
    copy12 = copy_ms(torch, dev, [x.numel() * 12 for x in xs])
    copy8 = copy_ms(torch, dev, [x.numel() * 8 for x in xs])
    times = {
        "fpisa_extract": time_kernel(
            torch, "fpisa_extract", lambda: [ops.extract(x, "fp32") for x in xs],
            lambda: [ref.extract_ref(x, fmt) for x in xs],
            elems * 12 + total_rows * 4, elems * OPS_PER_ELEM["fpisa_extract"], copy12, what),
        "fpisa_align": time_kernel(
            torch, "fpisa_align", lambda: [ops.align(e, m, b, 0) for e, m, b in planes],
            lambda: [ref.align_ref(e, m, b, 0) for e, m, b in planes],
            elems * 12 + total_rows * 4, elems * OPS_PER_ELEM["fpisa_align"], copy12, what),
        "fpisa_decode": time_kernel(
            torch, "fpisa_decode",
            lambda: [ops.decode(a, b, 0, "fp32") for a, (_, _, b) in zip(aligned, planes)],
            lambda: [ref.decode_ref(a, b, 0, fmt) for a, (_, _, b) in zip(aligned, planes)],
            elems * 8 + total_rows * 4, elems * OPS_PER_ELEM["fpisa_decode"], copy8, what,
            plain_reps=5),
    }
    return launches, times


def leaf_composition(torch, rows):
    """What the cuda backend's fpisa_seq ran around K6 before its leaf mode,
    on (W, N) bf16 rows: the float32 upcast, the staging cast, local mode
    over the (W, 1, N) stack and the cast back to bf16."""
    from repro_torch.core import fpisa
    from repro_torch.kernels import ops

    up = fpisa.to_packed(rows.to(torch.float32), "fp32")
    return ops.accum(up[:, None], "fpisa_a", "fp32").reshape(-1).to(torch.bfloat16)


def leaf_mode_timing(torch, dev, stacks, what):
    """K6's leaf mode over the bf16 (W, N) ``stacks`` (one per leaf), the
    fp32 format, against its bound, its plain version and a ``copy_`` of the
    same bytes, then beside the eager composition it replaced
    (``leaf_composition``: W x 6 + 8 + 6 bytes an element), host issue
    against CUDA events in turns; the two must give the same bits."""
    from repro_torch.core import fpisa
    from repro_torch.kernels import ops, ref

    w = stacks[0].shape[0]
    elems = sum(x.shape[1] for x in stacks)
    out = time_kernel(
        torch, "fpisa_accum", lambda: [ops.accum_leaf(x, "fpisa_a", "fp32") for x in stacks],
        lambda: [ref.accum_leaf_ref(x, "fpisa_a", fpisa.FP32) for x in stacks],
        elems * (2 * w + 2), elems * accum_ops_per_elem(w, bf16_leaf=True),
        copy_ms(torch, dev, [x.shape[1] * (2 * w + 2) for x in stacks]),
        f"leaf mode, {what}", plain_reps=3)
    for x in stacks:
        if not torch.equal(ops.accum_leaf(x, "fpisa_a", "fp32").view(torch.int16),
                           leaf_composition(torch, x).view(torch.int16)):
            raise AssertionError(f"leaf mode differs from the composition it replaced, {what}")
    runs = {"composition": lambda: [leaf_composition(torch, x) for x in stacks],
            "leaf mode": lambda: [ops.accum_leaf(x, "fpisa_a", "fp32") for x in stacks]}
    turns = {}
    for name in ("composition", "leaf mode", "composition", "leaf mode"):
        runs[name]()
        torch.cuda.synchronize()
        turns.setdefault(name, []).append(issue_vs_device(torch, runs[name]))
        torch.cuda.empty_cache()
    comp_bytes = elems * (6 * w + 4 * w + 4 + 6)
    log(f"[time] fpisa_accum: {what}: the composition leaf mode replaced (upcast, local mode, "
        f"cast back: {comp_bytes // elems} B an element, floor "
        f"{comp_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms) host issue / CUDA events "
        + ", ".join(f"{i:.3f} / {d:.3f}" for i, d in turns["composition"])
        + f" ms; leaf mode ({2 * w + 2} B an element) "
        + ", ".join(f"{i:.3f} / {d:.3f}" for i, d in turns["leaf mode"])
        + f" ms; same bits; {CARD}")
    out["composition"] = {"ms": min(d for _, d in turns["composition"]),
                          "bytes_ms": comp_bytes / HBM_BYTES_PER_S * 1e3, "turns": turns}
    return out


def accum_timing(torch, dev, leaf_sizes, par):
    """K6 at the fpisa_seq step's shape (W = 1 over the 14 leaves): leaf
    mode at the leaves' bf16 (what the fpisa_seq paths run) beside the
    eager composition it replaced (``leaf_mode_timing``), local mode at fp32
    leaves (the TPU kernel's function); then local mode at the accuracy
    shape (W = 8 stacks of the embedding leaf's shape, both variants, each
    also held against its plain version); then one step's fpisa_seq
    aggregation (``seq_aggregation_timing``). Returns leaf mode's times at
    the step's shape, with ``ms_by_mode``, the accuracy shape's and the
    aggregation's."""
    from repro_torch.core import fpisa
    from repro_torch.kernels import ops, ref

    fmt = fpisa.FP32
    xs = [x[None] for x in step_leaves(torch, dev, leaf_sizes)]
    elems = sum(x.numel() for x in xs)
    local = time_kernel(
        torch, "fpisa_accum", lambda: [ops.accum(x, "fpisa_a", "fp32") for x in xs],
        lambda: [ref.accum_ref(x, "fpisa_a", fmt) for x in xs],
        elems * 8, elems * accum_ops_per_elem(1), copy_ms(torch, dev, [x.numel() * 8 for x in xs]),
        f"local mode, fpisa_seq step, W = 1 over {len(xs)} leaves, {elems // 256} rows x 256 "
        f"fp32", plain_reps=5)
    bf16 = [x.reshape(1, -1).to(torch.bfloat16) for x in xs]
    del xs
    out = leaf_mode_timing(torch, dev, bf16, f"fpisa_seq step, W = 1 over {len(bf16)} leaves, "
                                             f"{elems} elements of bf16, fp32 format")
    del bf16
    out["ms_by_mode"] = {"local": local, "leaf": dict(out)}
    workers = ACCUM_WORKERS[-1]
    x = torch.stack([torch.nan_to_num(sample(torch, (EMBED_ROWS, 256), "fp32", 60 + i, dev),
                                      posinf=1.0, neginf=-1.0) for i in range(workers)])
    elems = EMBED_ROWS * 256
    copy = copy_ms(torch, dev, [elems * (workers + 1) * 4])
    accuracy = {}
    for variant in ("fpisa_a", "full"):
        par.check("fpisa_accum", ops.accum(x, variant, "fp32"),
                  ref.accum_ref(x, variant, fmt), f"embedding leaf W{workers} {variant}")
        accuracy[variant] = time_kernel(
            torch, "fpisa_accum", lambda: ops.accum(x, variant, "fp32"),
            lambda: ref.accum_ref(x, variant, fmt), elems * (workers + 1) * 4,
            elems * accum_ops_per_elem(workers), copy,
            f"local mode, accuracy shape, {variant}, W = {workers} x {EMBED_ROWS} x 256 fp32",
            plain_reps=3)
    del x
    torch.cuda.empty_cache()
    out["accuracy_shape"] = accuracy
    out["aggregation"] = seq_aggregation_timing(torch, dev, leaf_sizes)
    return out


def seq_aggregation_timing(torch, dev, leaf_sizes):
    """One step's ``fpisa_seq`` aggregation on the cuda backend through the
    Aggregator, as the training step calls it (the group's all-gather
    included): the 14 leaves in bf16 at W = 1, then their (4, ...) stacks
    at W = 4 logical workers; host issue against CUDA events, two turns
    each. Returns {"flat": [(issue ms, events ms)], "stacked": [...]}."""
    from repro_torch.core.agg import AggConfig, Aggregator

    cfg = AggConfig(strategy="fpisa_seq", backend="cuda")
    xs = [x.to(torch.bfloat16) for x in step_leaves(torch, dev, leaf_sizes)]
    runs = {"flat": (Aggregator(cfg), xs)}
    k = LOGICAL_WORKERS
    workers = [step_leaves(torch, dev, leaf_sizes, seed=100 * j) for j in range(k)]
    runs["stacked"] = (Aggregator(cfg, stacked=True),
                       [torch.stack(per_leaf).to(torch.bfloat16) for per_leaf in zip(*workers)])
    del workers
    out = {}
    for name in ("flat", "stacked", "flat", "stacked"):
        agg, leaves = runs[name]
        agg.allreduce_tree(leaves)
        torch.cuda.synchronize()
        out.setdefault(name, []).append(issue_vs_device(torch, lambda: agg.allreduce_tree(leaves)))
    elems = sum(x.numel() for x in xs)
    log(f"[time] one step's fpisa_seq aggregation (cuda backend, the Aggregator, the group's "
        f"all-gather included), {len(xs)} bf16 leaves of {elems} elements, host issue / CUDA "
        f"events: W = 1 " + ", ".join(f"{i:.3f} / {d:.3f}" for i, d in out["flat"])
        + f" ms; stacked W = {k} " + ", ".join(f"{i:.3f} / {d:.3f}" for i, d in out["stacked"])
        + f" ms; {CARD}")
    return out


def switch_emu_smoke(torch, dev):
    """switch_emu at smoke size: the same losses as fpisa_seq over 3 steps,
    and one leaf through both aggregators with the same bits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.agg import AggConfig, Aggregator
    from repro_torch.launch.train import train_loop

    smoke = get_smoke_config("qwen1.5-0.5b")
    runs = {s: train_loop(smoke, steps=STEPS, global_batch=4, seq_len=64, device=dev,
                          agg=AggConfig(strategy=s), log_every=STEPS)[2]
            for s in ("switch_emu", "fpisa_seq")}
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["switch_emu"], runs["fpisa_seq"]))
    if rel > 1e-6:
        raise AssertionError(f"smoke losses differ between switch_emu and fpisa_seq: {runs}")
    log(f"[switch_emu] smoke losses, switch_emu vs fpisa_seq (rtol 1e-6, largest {rel:.2e}): "
        f"{runs}")
    x = torch.nan_to_num(sample(torch, (1024, 256), "fp32", 77, dev), posinf=1.0, neginf=-1.0)
    a = Aggregator(AggConfig(strategy="switch_emu")).allreduce(x)
    b = Aggregator(AggConfig(strategy="fpisa_seq")).allreduce(x)
    if not (torch.equal(a.view(torch.int32), b.view(torch.int32)) and a.is_cuda):
        raise AssertionError("one leaf: switch_emu != fpisa_seq")
    log(f"[switch_emu] one {tuple(x.shape)} leaf: switch_emu (numpy dataplane on the host) "
        f"bit-equal to fpisa_seq (K6 on the card)")


# ---------------------------------------------------------------------------
# the sixth slice: the switch dataplane and in-switch query processing
# ---------------------------------------------------------------------------


def smoke_vectors(workers, n, seed, scale=1e-3):
    """Gradient-like (workers, n) float32 rows from a numpy seed."""
    import numpy as np

    v = np.random.default_rng(seed).standard_normal((workers, n), dtype=np.float32)
    v *= np.float32(scale)
    return v


def same_f32(a, b):
    import numpy as np

    return np.array_equal(np.ascontiguousarray(a, np.float32).view(np.int32),
                          np.ascontiguousarray(b, np.float32).view(np.int32))


def profiled_events(torch, run):
    """torch.profiler's ``key_averages()`` of one ``run()``, or None when the
    profiler fails (it is a measurement only: the line then says so)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    except RuntimeError:
        return None
    return prof.key_averages()


def device_profile(torch, run):
    """(kernel ms, kernel launches) of one ``run()`` from torch.profiler, or
    None when the profiler records no device time."""
    from torch.autograd import DeviceType

    events = profiled_events(torch, run) or []
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0) for e in kernels) / 1e3
    return (busy, sum(e.count for e in kernels)) if busy else None


def host_split(fn, funcs):
    """cProfile of ``fn()``: (host wall s, {label: cumulative s}) for each
    function of ``funcs`` ({label: function}), matched by its code object."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    prof.disable()
    wall = time.perf_counter() - t0
    codes = {(f.__code__.co_filename, f.__code__.co_firstlineno, f.__code__.co_name): label
             for label, f in funcs.items()}
    out = dict.fromkeys(funcs, 0.0)
    for key, (_, _, _, cumulative, _) in pstats.Stats(prof).stats.items():
        if key in codes:
            out[codes[key]] += cumulative
    return wall, out


def issue_vs_device(torch, run, reps=5):
    """Host issue time (host clock, no synchronize) and CUDA-event time of
    ``run()``, medians of ``reps`` (the caller warms up)."""
    issue, device = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        run()
        issue.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end))
    return statistics.median(issue), statistics.median(device)


def timed(torch, fn):
    """(result, host wall s, CUDA-event s) of ``fn()``, ending in a
    synchronize."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end) / 1e3


def switchsim_parity(torch, dev):
    """Check (a): the card's BatchedDataplane against the port's numpy
    dataplane on the host and the per-packet FpisaSwitch on the card, at a
    small size: both variants, P = 1 and 4, drop 0 and 0.3, a worker
    failure, and J = 2 with overlapping quotas and priorities (1, 0); bits
    and counters."""
    from repro_torch import switchsim
    from repro_torch.core import switch as legacy

    vec = smoke_vectors(4, 40 * 256, seed=1, scale=1.0)
    cases = 0
    for variant in ("fpisa_a", "full"):
        for pipes in (1, 4):
            for drop, fail in ((0.0, None), (0.3, None), (0.3, 2)):
                kw = dict(num_workers=4, num_slots=4, num_pipelines=pipes, variant=variant)
                fabric = dict(drop_prob=drop, seed=3)
                if fail is not None:
                    fabric.update(fail_worker=fail, fail_round=3)
                card = switchsim.BatchedDataplane(switchsim.DataplaneConfig(**kw), device=dev)
                host = switchsim.NumpyDataplane(switchsim.DataplaneConfig(**kw))
                got = switchsim.run_aggregation(card, vec, **fabric)
                want = switchsim.run_aggregation(host, vec, **fabric)
                if not (same_f32(got, want) and card.stats == host.stats):
                    raise AssertionError(f"[switchsim] (a) card != numpy: {kw} {fabric}: "
                                         f"{card.stats} vs {host.stats}")
                cases += 1
                if pipes == 1 and fail is None:
                    sw = legacy.FpisaSwitch(legacy.SwitchConfig(
                        num_workers=4, num_slots=4, variant=variant), device=dev)
                    per_packet = switchsim.run_aggregation(sw, vec[:, :16 * 256], **fabric)
                    if not same_f32(per_packet, switchsim.run_aggregation(
                            switchsim.NumpyDataplane(switchsim.DataplaneConfig(**kw)),
                            vec[:, :16 * 256], **fabric)):
                        raise AssertionError(f"[switchsim] (a) per-packet != numpy: {kw}")
                    cases += 1
    kw = dict(num_workers=5, num_slots=8, num_pipelines=2, num_jobs=2, job_slots=(8, 6),
              job_workers=(4, 1), job_priorities=(1, 0), stale_after=2)
    vs = [vec, smoke_vectors(1, 20 * 256, seed=2, scale=1.0)]
    out = {}
    for name, dp in (("card", switchsim.BatchedDataplane(switchsim.DataplaneConfig(**kw),
                                                         device=dev)),
                     ("host", switchsim.NumpyDataplane(switchsim.DataplaneConfig(**kw)))):
        out[name] = switchsim.run_multitenant(dp, vs, drop_prob=0.2, seed=4)
    (fc, rc), (fh, rh) = out["card"], out["host"]
    if not (all(same_f32(a, b) for a, b in zip(fc, fh)) and rc == rh):
        raise AssertionError(f"[switchsim] (a) J = 2 card != numpy: {rc} vs {rh}")
    log(f"[switchsim] check (a): the card's BatchedDataplane == the numpy dataplane "
        f"(bits, stats) in {cases} single-tenant cases (fpisa_a/full x P 1/4 x drop 0/0.3, "
        f"a worker failure; FpisaSwitch per packet on the card at P = 1), and J = 2 "
        f"(overlapping quotas (8, 6), priorities (1, 0), drop 0.2): bits, job_stats "
        f"{rc['job_stats']}, done_round {rc['done_round']}")


def check_against_k6(torch, dev, vec3, out, arrivals, variant):
    """The stream's result against K6 in arrival order: the chunks grouped
    by their arrival permutation, each group's permuted (W, n, 256) stack
    through ``ops.accum``. Returns the number of groups."""
    import numpy as np

    from repro_torch.kernels import ops

    w, nchunks, e = vec3.shape
    perms = np.array([arrivals[c] for c in range(nchunks)], np.int64)
    got = out.reshape(nchunks, e)
    groups, inverse = np.unique(perms, axis=0, return_inverse=True)
    for g, perm in enumerate(groups):
        idx = np.nonzero(inverse.reshape(-1) == g)[0]
        stack = torch.from_numpy(vec3[:, idx][perm]).to(dev)
        want = ops.accum(stack, variant, "fp32").cpu().numpy()
        if not same_f32(got[idx], want):
            raise AssertionError(f"[switchsim] (b) {variant}: chunks of arrival order "
                                 f"{perm.tolist()} differ from K6")
    return len(groups)


def switchsim_stream(torch, dev, vecs):
    """Check (b): the full-size stream, (W, N) = ``vecs``, through the card's
    BatchedDataplane (4 pipelines x 256 slots: G = 2048, a window of 1024
    chunks) for both variants at drop 0 and 0.01, each result held against
    K6 in arrival order; then one driver round's ingest call profiled."""
    import numpy as np

    from repro_torch import switchsim
    from repro_torch.switchsim import dataplane

    w, n = vecs.shape
    vec3 = vecs.reshape(w, -1, 256)
    rows = {}
    for variant in ("fpisa_a", "full"):
        cfg = switchsim.DataplaneConfig(num_workers=w, num_slots=SWITCH_SLOTS,
                                        elems_per_packet=256, num_pipelines=SWITCH_PIPES,
                                        variant=variant)
        for drop in (0.0, 0.01):
            dp = switchsim.BatchedDataplane(cfg, device=dev)
            (out, arrivals), wall, events = timed(torch, lambda: switchsim.run_aggregation(
                dp, vecs, drop_prob=drop, seed=5, record_arrivals=True, max_rounds=100_000))
            groups = check_against_k6(torch, dev, vec3, out, arrivals, variant)
            st = dp.stats
            sent = st["packets"] + st["duplicates"] + st["stale"] + st["admission_denied"]
            rounds = dp.last_now + 1
            rows[(variant, drop)] = dict(driver_rounds=rounds, calls=dp.calls,
                                         inner_rounds=dp.rounds_run, wall_s=wall,
                                         events_s=events, packets_per_s=sent / wall, stats=st)
            log(f"[switchsim] (b) {variant}, drop {drop}: {w} x {n:,} elements "
                f"({vec3.shape[1]:,} chunks of 256), G = {cfg.total_slots}, window "
                f"{cfg.window}: equal to K6 in arrival order, bit for bit ({groups} arrival "
                f"order{'s' if groups > 1 else ''}); {rounds} driver rounds, {dp.calls} "
                f"device calls, {dp.rounds_run} inner rounds; host wall {wall:.3f} s, CUDA "
                f"events {events:.3f} s; {sent:,} packets, {sent / wall:,.0f} packets/s; "
                f"stats {st}; {CARD}")
    # one driver round's device call (4,096 packets, 4 inner rounds) alone
    cfg = switchsim.DataplaneConfig(num_workers=w, num_slots=SWITCH_SLOTS, elems_per_packet=256,
                                    num_pipelines=SWITCH_PIPES)
    state = dataplane.init_state(cfg, dev)
    b = w * cfg.window
    wk = torch.arange(w, device=dev).repeat_interleave(cfg.window).int()
    ck = torch.arange(cfg.window, device=dev).repeat(w).int()
    pl = torch.from_numpy(np.ascontiguousarray(vec3[:, :cfg.window].reshape(b, 256))).to(dev)
    ones = torch.ones(b, dtype=torch.bool, device=dev)
    jobs = torch.zeros(b, dtype=torch.int32, device=dev)

    def call():
        return dataplane.ingest_batch(state, wk, ck, pl, ones, jobs, 0, cfg=cfg, rounds=w)

    call()
    torch.cuda.synchronize()
    issue, device = issue_vs_device(torch, call)
    prof = device_profile(torch, call)
    lossless = rows[("fpisa_a", 0.0)]
    per_round_ms = lossless["wall_s"] * 1e3 / lossless["driver_rounds"]
    busy = "not measured (the profiler recorded no device time)" if prof is None else (
        f"kernels {prof[0]:.3f} ms in {prof[1]} launches = {prof[1] / w:.1f} per inner round; "
        f"device busy {100 * prof[0] / device:.1f} % of the call's events, "
        f"{100 * prof[0] / per_round_ms:.1f} % of a lossless driver round's host wall "
        f"{per_round_ms:.3f} ms")
    log(f"[switchsim] (b) one driver round's device call ({b} packets, {w} inner rounds, "
        f"fpisa_a): host issue {issue:.3f} ms, CUDA events {device:.3f} ms (median of 5); "
        f"{busy}; {CARD}")
    # where a driver round's host time goes: cProfile over the first 30 windows
    from repro_torch.core import fpisa

    part = np.ascontiguousarray(vecs[:, :30 * cfg.window * 256])
    dp = switchsim.BatchedDataplane(cfg, device=dev)
    wall, split = host_split(
        lambda: switchsim.run_aggregation(dp, part, record_arrivals=True),
        {"driver": dataplane._drive_rounds, "handle": dataplane.BatchedDataplane.ingest_batch,
         "device_fn": dataplane.ingest_batch, "renormalize": fpisa.renormalize})
    r = dp.last_now + 1
    log(f"[switchsim] (b) host split of a {r}-round lossless fpisa_a run (cProfile, which "
        f"slows every Python call): {1e3 * wall / r:.2f} ms a driver round = the dataplane's "
        f"torch calls {1e3 * split['device_fn'] / r:.2f} ms (of which the always-computed "
        f"renormalize {1e3 * split['renormalize'] / r:.2f} ms) + the host handle's padding "
        f"and copies {1e3 * (split['handle'] - split['device_fn']) / r:.2f} ms + the driver's "
        f"numpy and Python {1e3 * (split['driver'] - split['handle']) / r:.2f} ms; {CARD}")
    return {f"{v}@{d}": r for (v, d), r in rows.items()}


def switchsim_tenancy(torch, dev, vecs, keys, values):
    """Check (c): the training stream and a one-port StreamedGroupBySum query
    stream on one card dataplane, ``job_workers=(4, 1)``, priorities (1, 0):
    disjoint quotas (each job bit-equal to its single-tenant run), then a
    fully shared pool (query totals within rel 1e-4 of the full scan)."""
    from repro_torch import switchsim
    from repro_torch.db import query as q

    gb = q.StreamedGroupBySum(num_groups=GROUPS, elems_per_packet=256)
    qvec = gb.vectors(keys, values, batch=4096)
    want = q.spark_like_groupby(keys, values)
    w = vecs.shape[0]
    base = dict(num_workers=w, num_slots=SWITCH_SLOTS, elems_per_packet=256,
                num_pipelines=SWITCH_PIPES, num_jobs=2, job_workers=(w, 1),
                job_priorities=(1, 0))
    quotas = (SWITCH_SLOTS - SWITCH_SLOTS // 4, SWITCH_SLOTS // 4)
    for name, extra in (("disjoint", dict(job_slots=quotas)), ("shared", {})):
        cfg = switchsim.DataplaneConfig(**base, **extra)
        dp = switchsim.BatchedDataplane(cfg, device=dev)
        ((tflat, qflat), rep), wall, events = timed(
            torch, lambda: switchsim.run_multitenant(dp, [vecs, qvec], max_rounds=100_000))
        got = gb.finalize(qflat)
        worst = max(abs(got[k] - v) / abs(v) for k, v in want.items())
        if name == "disjoint":
            for j, (vals, flat) in enumerate(((vecs, tflat), (qvec, qflat))):
                alone = switchsim.BatchedDataplane(switchsim.DataplaneConfig(
                    num_workers=vals.shape[0], num_slots=quotas[j], elems_per_packet=256,
                    num_pipelines=SWITCH_PIPES), device=dev)
                if not same_f32(flat, switchsim.run_aggregation(alone, vals, max_rounds=100_000)):
                    raise AssertionError(f"[switchsim] (c) disjoint quotas: job {j} differs "
                                         f"from its single-tenant run")
        if worst > 1e-4:
            raise AssertionError(f"[switchsim] (c) {name}: query totals off by rel {worst:.2e}")
        rates = [s["packets"] / d for s, d in zip(rep["job_stats"], rep["done_round"])]
        log(f"[switchsim] (c) {name} pool{' ' + str(quotas) if extra else ''}: training "
            f"{vecs.shape[0]} x {vecs.shape[1]:,} + query {len(keys):,} rows in "
            f"{qvec.shape[1] // 256} packets: done_round {rep['done_round']} of "
            f"{rep['rounds']}; job_stats {rep['job_stats']}; Jain fairness of packets per "
            f"round {switchsim.jain_fairness(rates):.4f}; query totals within rel "
            f"{worst:.2e} of spark_like_groupby"
            + ("; each job bit-equal to its single-tenant run" if extra else "")
            + f"; host wall {wall:.3f} s, CUDA events {events:.3f} s; {CARD}")


def switchsim_shared_agg(torch, dev):
    """Check (d): two switch_emu Aggregators share one named dataplane at
    smoke size, on the card's tensors (the NCCL group); the bits of the same
    on CPU tensors (a one-rank gloo group)."""
    import torch.distributed as dist

    from repro_torch import switchsim
    from repro_torch.core.agg import AggConfig, Aggregator

    xs = [torch.from_numpy(smoke_vectors(1, 3000, seed=20 + j)[0]) for j in (0, 1)]
    cpu_group = dist.new_group(backend="gloo") if dist.is_initialized() else None
    outs = {}
    for label, where, group in (("card", dev, None), ("cpu", torch.device("cpu"), cpu_group)):
        switchsim.reset_shared_dataplanes()
        outs[label] = [Aggregator(AggConfig(
            strategy="switch_emu", switch_shared="chip-smoke", switch_jobs=2,
            switch_job=j), group).allreduce(x.to(where)).cpu().numpy()
            for j, x in enumerate(xs)]
        stats = switchsim.shared_dataplane("chip-smoke", switchsim.DataplaneConfig(
            num_workers=1, num_jobs=2, job_workers=(1, 1))).job_stats
        if not all(s["packets"] > 0 for s in stats):
            raise AssertionError(f"[switchsim] (d) a tenant sent nothing: {stats}")
    switchsim.reset_shared_dataplanes()
    if not all(same_f32(a, b) for a, b in zip(outs["card"], outs["cpu"])):
        raise AssertionError("[switchsim] (d) shared switch_emu: card != CPU")
    log(f"[switchsim] check (d): two switch_emu Aggregators (switch_job 0, 1) on one named "
        f"dataplane, card tensors == CPU tensors bit for bit; job_stats {stats}")


def switchsim_path(torch, dev, vecs, keys, values):
    """The sixth slice's dataplane phase; K6 is the oracle of (b), so its
    launches are the ``switchsim`` path's (counts zeroed just before (a),
    read just after (b))."""
    t0 = time.perf_counter()
    zero_launches()
    switchsim_parity(torch, dev)
    streams = switchsim_stream(torch, dev, vecs)
    launches = k6_subset(read_launches())
    if launches["fpisa_accum@local"] == 0 or launches["fpisa_accum@leaf"]:
        raise AssertionError(f"[switchsim] K6 ran as the stream's oracle in local mode only, "
                             f"at least once: {launches}")
    switchsim_tenancy(torch, dev, vecs, keys, values)
    switchsim_shared_agg(torch, dev)
    log(json.dumps({"switchsim_launches": launches, "streams": streams}))
    log(f"[switchsim] phase {time.perf_counter() - t0:.1f} s")
    return launches


def uservisits():
    """The uservisits table's adRevenue column, drawn as the reference's
    example draws it (gamma(2, 50), float32, numpy seed 1), ``QUERY_ROWS``
    rows, and a group key in [0, ``GROUPS``) for the first ``GROUP_ROWS``."""
    import numpy as np

    rng = np.random.default_rng(1)
    revenue = rng.gamma(2.0, 50.0, QUERY_ROWS).astype(np.float32)
    return revenue, rng.integers(0, GROUPS, GROUP_ROWS)


def query_path(torch, dev, revenue, keys):
    """Checks (e) and (f): the adRevenue column uploaded to the card once;
    Top-10 over ``QUERY_ROWS`` rows in batches of ``QUERY_BATCH`` exact
    against the full scan; group-by SUM of ``GROUPS`` groups over
    ``GROUP_ROWS`` rows, the timed run's final planes equal to a CPU run's
    over the same rows and its totals within the reference's rel 2e-3 of the
    full scan (tests/test_db.py); then ``python -m repro_torch.launch.query``
    on the card."""
    import numpy as np

    from repro_torch.core import fpisa
    from repro_torch.db import query as q
    from repro_torch.switchsim import query as swq

    t_phase = time.perf_counter()
    (col,), up_wall, up_ev = timed(torch, lambda: (torch.from_numpy(revenue).to(dev),))
    pruner = q.TopNPruner(n=10, device=dev)
    surv, wall, events = timed(torch, lambda: pruner.run(col, batch=QUERY_BATCH))
    t0 = time.perf_counter()
    exact = q.spark_like_topn(revenue, 10)
    scan = time.perf_counter() - t0
    top = np.sort(revenue[surv])[::-1][:10]
    if not np.array_equal(top, exact):
        raise AssertionError(f"[query] (e) Top-10 differs from the full scan: {top} vs {exact}")
    log(f"[query] (e) Top-10 over {QUERY_ROWS:,} rows ({revenue.nbytes / 1e6:.0f} MB on the "
        f"card, uploaded once in {up_wall:.3f} s), batches of {QUERY_BATCH:,}: exact; "
        f"prune rate {pruner.stats.prune_rate:.6f} ({pruner.stats.rows_out:,} rows reached "
        f"the master); host wall {wall:.3f} s, CUDA events {events:.3f} s = "
        f"{QUERY_ROWS / wall:,.0f} rows/s; full-scan sort on the host {scan:.3f} s = "
        f"{QUERY_ROWS / scan:,.0f} rows/s; {CARD}")
    del col
    vals = revenue[:GROUP_ROWS]
    kd, vd = torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev)
    agg = q.GroupBySum(num_slots=GROUPS, variant="full", device=dev)
    got, wall, events = timed(torch, lambda: agg.run(kd, vd))
    t0 = time.perf_counter()
    cpu = q.GroupBySum(num_slots=GROUPS, variant="full", device="cpu")
    cpu.run(keys, vals)
    cpu_wall = time.perf_counter() - t0
    for name in ("exp", "man", "since"):
        if not torch.equal(getattr(agg, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"[query] (e) group-by {name} plane: card != CPU")
    t0 = time.perf_counter()
    want = q.spark_like_groupby(keys, vals)
    base = time.perf_counter() - t0
    worst = max(abs(got[k] - v) / v for k, v in want.items())
    if sorted(got) != sorted(want) or not worst < 2e-3:
        raise AssertionError(f"[query] (e) group-by totals: worst rel err {worst:.3e} "
                             f"(bound 2e-3) over groups {sorted(got)}")

    def one_batch():
        q.GroupBySum(num_slots=GROUPS, variant="full", device=dev).run(kd[:PROFILED_ROWS],
                                                                       vd[:PROFILED_ROWS])

    prof = device_profile(torch, one_batch)
    batch_wall, split = host_split(one_batch, {"ingest": swq.groupby_ingest,
                                               "renormalize": fpisa.renormalize,
                                               "encode": fpisa.encode})
    busy = ("device busy not measured" if prof is None else
            f"one {PROFILED_ROWS:,}-row batch profiled: kernels {prof[0]:.1f} ms in {prof[1]:,} "
            f"launches") + (
        f"; cProfile of that batch: {batch_wall:.3f} s, groupby_ingest "
        f"{split['ingest']:.3f} s, of which the always-computed flush's renormalize "
        f"{split['renormalize']:.3f} s and "
        f"encode (once more per call) {split['encode']:.3f} s")
    log(f"[query] (e) group-by SUM, {GROUPS} groups, full FPISA, {GROUP_ROWS:,} rows on the "
        f"card: planes == a CPU run's over the same rows bit for bit (CPU {cpu_wall:.3f} s); "
        f"largest rel err {worst:.3e} against spark_like_groupby (bound 2e-3); host wall "
        f"{wall:.3f} s, CUDA events {events:.3f} s = {GROUP_ROWS / wall:,.0f} rows/s; "
        f"{busy}; the baseline on the host {base:.3f} s = {GROUP_ROWS / base:,.0f} rows/s; "
        f"{CARD}")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.query"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"[query] (f) launch.query failed: {res.stderr[-2000:]}")
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    log(f"[query] (f) python -m repro_torch.launch.query on the card ran to its end in "
        f"{time.perf_counter() - t0:.1f} s: " + " | ".join(lines))
    log(f"[query] phase {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    t0 = time.perf_counter()
    laps = {}  # phase -> seconds, for the last [smoke] line

    def lap(name):
        laps[name] = round(time.perf_counter() - t0 - sum(laps.values()), 1)

    if not (SRC / "repro_torch" / "kernels").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    from repro_torch.launch.mesh import HBM_BW

    global HBM_BYTES_PER_S
    HBM_BYTES_PER_S = HBM_BW  # H100 SXM data sheet

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script drives the port on a GPU",
              file=sys.stderr)
        return 2
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = card_facts(torch)
    build_kernels()
    lap("build")
    par = Parity(torch)
    kernel_parity(torch, dev, par)
    two_pass_accum_parity(torch, dev, par)
    lap("parity")

    tmpdir = ROOT / "build" / "chip_smoke"
    tmpdir.mkdir(parents=True, exist_ok=True)
    rendezvous = tmpdir / "nccl_rendezvous"
    rendezvous.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}", rank=0,
                            world_size=1)
    try:
        paths = {}  # path -> {kernel: launches}, each counted from zero over its run
        paths["main"], model, opt_state = train_main_path(torch, dev)
        check_against_plain(torch, dev, model)
        parts = step_breakdown(torch, dev, model, opt_state, "fpisa")
        log(f"[longctx] (e) {model.cfg.name} forward+backward of {GLOBAL_BATCH} x {SEQ_LEN} "
            f"through A1 (remat full): {parts['forward+backward']:.2f} ms; with the whole (S, S) "
            f"float32 softmax in its place it took 147-186 ms (PERF.md §5); {CARD}")
        leaf_sizes = [p.numel() for p in model.parameters()]
        del model, opt_state
        torch.cuda.empty_cache()
        lap("main")
        paths["fpisa_seq"], model, opt_state = train_seq_path(torch, dev)
        check_grads_cuda_equals_plain(torch, dev, model, "fpisa_seq")
        step_breakdown(torch, dev, model, opt_state, "fpisa_seq")
        torch.cuda.empty_cache()
        paths["bucketed"] = bucketed_path(torch, dev, model, tmpdir)
        del model, opt_state
        torch.cuda.empty_cache()
        lap("fpisa_seq+bucketed")
        stacked_launches, stacked_times = stacked_path(torch, dev, tmpdir, leaf_sizes)
        paths.update(stacked_launches)
        torch.cuda.empty_cache()
        lap("stacked")
        for name, path in (("fig9", fig9_path), ("serve", serve_path), ("models", models_path),
                           ("encdec", encdec_path), ("sharding", sharding_path)):
            paths.update(path(torch, dev))
            torch.cuda.empty_cache()
            lap(name)
        longctx_paths, a1_times = longctx_path(torch, dev, par)
        paths.update(longctx_paths)
        torch.cuda.empty_cache()
        lap("longctx")
        s1_times = s1_line(torch, dev, par)
        torch.cuda.empty_cache()
        lap("s1")
        o1_times = o1_line(torch, dev, par)
        torch.cuda.empty_cache()
        lap("o1")
        times = timing(torch, dev, leaf_sizes)
        times.update(a1_times)
        times.update(s1_times)
        times.update(o1_times)
        paths["two_pass"], two_pass_times = two_pass_pipeline(torch, dev, leaf_sizes, par)
        times.update(two_pass_times)
        torch.cuda.empty_cache()
        times["fpisa_accum"] = accum_timing(torch, dev, leaf_sizes, par)
        torch.cuda.empty_cache()
        lap("timing")
        switch_emu_smoke(torch, dev)
        revenue, keys = uservisits()
        vecs = smoke_vectors(STREAM_WORKERS, STREAM_ELEMS, seed=0)
        paths["switchsim"] = switchsim_path(torch, dev, vecs, keys, revenue[:GROUP_ROWS])
        del vecs
        torch.cuda.empty_cache()
        lap("switch")
        query_path(torch, dev, revenue, keys)
        lap("query")
    finally:
        dist.destroy_process_group()

    sources = {"fused_encode_align": "src/repro_torch/csrc/fpisa_fused.cu",
               "fused_decode": "src/repro_torch/csrc/fpisa_fused.cu",
               "fpisa_extract": "src/repro_torch/csrc/fpisa_encode.cu",
               "fpisa_align": "src/repro_torch/csrc/fpisa_encode.cu",
               "fpisa_decode": "src/repro_torch/csrc/fpisa_fused.cu",
               "fpisa_accum": "src/repro_torch/csrc/fpisa_accum.cu",
               "chunked_attention_fwd": "src/repro_torch/csrc/chunked_attention.cu",
               "chunked_attention_bwd": "src/repro_torch/csrc/chunked_attention.cu",
               "ssd_forward": "src/repro_torch/csrc/ssd_chunked.cu",
               "ssd_backward": "src/repro_torch/csrc/ssd_chunked.cu",
               "adamw_norm": "src/repro_torch/csrc/adamw.cu",
               "adamw_update": "src/repro_torch/csrc/adamw.cu"}
    replaces = {"fused_encode_align": "src/repro/kernels/fpisa_fused.py:66",
                "fused_decode": "src/repro/kernels/fpisa_fused.py:96",
                "fpisa_extract": "src/repro/kernels/fpisa_encode.py:47",
                "fpisa_align": "src/repro/kernels/fpisa_encode.py:73",
                "fpisa_decode": "src/repro/kernels/fpisa_decode.py:28",
                "fpisa_accum": "src/repro/kernels/fpisa_accum.py:41",
                # A1 replaces a jnp function (no Pallas kernel): its forward and
                # the autodiff of its remat'd pair step
                "chunked_attention_fwd": "src/repro/models/attention.py:67",
                "chunked_attention_bwd": "src/repro/models/attention.py:142",
                # S1 likewise: Mamba2's plain-jnp SSD scan and its autodiff
                "ssd_forward": "src/repro/models/mamba2.py:72",
                "ssd_backward": "src/repro/models/mamba2.py:72",
                # O1 likewise: the plain-jnp clip and AdamW update
                "adamw_norm": "src/repro/optim/optimizers.py:49",
                "adamw_update": "src/repro/optim/optimizers.py:57"}
    a1_routes = check_a1_routes(paths)
    # launches: the sum over every path that ran the kernel; launches_by_path:
    # each path's count, zeroed just before the path and read just after
    by_path = {name: {path: n[name] for path, n in paths.items() if name in n}
               for name in KERNELS}
    kernels = [{"name": name, "route": "cuda", "source": sources[name],
                "replaces": replaces[name],
                "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
                "max_abs_err": float(par.err[name]), "ms": times[name]["ms"],
                "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
                "bound_by": times[name]["bound_by"],
                "library_ms": times[name].get("library_ms"),
                **({"launches_by_route": {p: {r: v[A1.index(name)] for r, v in rs.items()}
                                          for p, rs in a1_routes.items()}}
                   if name in A1 else {}),
                **({"launches_by_mode": {p: {k.split("@")[1]: v for k, v in n.items()
                                             if k.startswith(name + "@")}
                                         for p, n in paths.items() if name + "@local" in n
                                         or name + "@leaf" in n},
                    "ms_by_mode": {m: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "copy_ms")}
                                   for m, t in times[name]["ms_by_mode"].items()}}
                   if name in K1K2 + ("fpisa_accum",) else {})}
               for name in KERNELS]
    log(f"[smoke] every phase passed in {time.perf_counter() - t0:.1f} s (by phase: "
        f"{json.dumps(laps)}); {CARD}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
