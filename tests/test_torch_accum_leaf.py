"""K6's leaf mode on the CPU, and the fpisa_seq paths that run it.

The cuda backend's ``fpisa_seq`` paths gather each leaf in its own dtype and
sum it with K6's leaf mode (``ops.accum_leaf``): the widening to the format,
the switch-arrival sum (worker 0 first) and the cast back to the leaf's
dtype in one pass. Here CPU tensors take its plain version
(``kernels/ref.py::accum_leaf_ref``), which must be BIT-EQUAL to the JAX
reference's ``fpisa_seq`` body (``repro.core.allreduce.fpisa_seq_allreduce``:
the float32 upcast, ``fpisa_sum_sequential``, ``.astype(leaf dtype)``), for
every (format, leaf dtype) pair the mode reads, W in {1, 2, 3, 4, 8} and both
variants, on words with +-0, denormals, +-inf, NaN of both signs, the range
edges, FPISA-A's headroom columns and sums that round to inf at the final
cast.

The kernel's per-element arithmetic (``csrc/fpisa_fused.cuh``: widen,
encode, the branch-free ``accum_add``, ``accum_out``) is compiled with the
host's g++ and held to the same plain versions, in both modes.

And two gloo ranks run ``fpisa_seq`` on the torch backend and on the cuda
backend's path (``ops`` on CPU tensors takes the plain versions), per leaf
and stacked (k = 2 a rank, W = 4): the leaf is gathered in its own dtype
where the format widens it, staged first where it does not, and every result
equals the reference's bits.
"""
import ctypes
import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fpisa as jf  # noqa: E402
from repro_torch.core import fpisa as tf  # noqa: E402
from repro_torch.kernels import fpisa_fused, ops, ref  # noqa: E402
from test_torch_fused_wire import CSRC, INT, JDT, PAIRS, TDT, _bits, _jax, _torch, _words  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N = 1536
WORKERS = [1, 2, 3, 4, 8]
CASES = [(fmt, leaf, w, v) for fmt, leaf in PAIRS for w in WORKERS for v in ("fpisa_a", "full")]
IDS = [f"{f}-{l}-W{w}-{v}" for f, l, w, v in CASES]


def _leaf_words(fmt, leaf, w, seed):
    """(W, N) raw words: ``_words``'s values, non-finite words and edges,
    then FPISA-A's headroom columns where the leaf has the format's exponent
    range (columns 0-4: the largest mantissa at exponent = headroom from
    every worker, shifted left into the exponent-0 accumulator, the second
    one wrapping the register; column 4 from worker 1 at headroom + 1, an
    overwrite), and sums that round to inf only at the cast back to the
    leaf's dtype (columns 5-6)."""
    words = _words(leaf, (w, N), seed)
    if leaf == fmt or (leaf, fmt) == ("bf16", "fp32"):
        h, lf = tf.FORMATS[fmt].headroom, tf.FORMATS[leaf]
        words[:, :5] = (h << lf.man_bits) | lf.man_mask
        words[1:2, 4] = ((h + 1) << lf.man_bits) | lf.man_mask
    if leaf != fmt:  # the format holds the sum, the leaf's dtype does not
        words[:, 5:7] = 0
        if leaf == "fp16":  # 65504 + 16 = 65520, the midpoint to inf; 65504 + 18
            words[0, 5:7], words[1:2, 5:7] = 0x7BFF, [0x4C00, 0x4C80]
        else:  # bf16 max + 2^119 (+ 2^118): at and past the midpoint to inf
            words[0, 5:7], words[1:2, 5:7], words[2:3, 6] = 0x7F7F, 0x7B00, 0x7A80
    return words


@functools.lru_cache(maxsize=None)
def _seq_body(fmt, leaf, variant):
    """The reference's fpisa_seq body (``repro.core.allreduce.
    fpisa_seq_allreduce`` less the all-gather: the float32 upcast,
    ``fpisa_sum_sequential``, the cast back), under ``jax.jit`` as the
    reference runs it: one compile per (format, leaf dtype, variant)."""
    f = jf.FORMATS[fmt]
    return jax.jit(lambda x: jf.fpisa_sum_sequential(
        x.astype(jnp.float32), f, variant=variant).astype(JDT[leaf]))


def _reference(blocks, fmt, leaf, variant):
    """The reference's fpisa_seq body on each (W, N) block of words, W <= 8,
    in one call: the blocks side by side in one (8, 5 N) stack (one shape,
    so each body compiles once), each padded to 8 workers with zeros, which
    add nothing in either variant (a zero's exponent 0 is never above the
    accumulator's, its mantissa is 0)."""
    side = np.zeros((max(WORKERS), len(WORKERS) * N), blocks[0].dtype)
    for k, block in enumerate(blocks):
        side[:block.shape[0], k * N:(k + 1) * N] = block
    out = np.array(_seq_body(fmt, leaf, variant)(_jax(side, leaf))).view(INT[leaf][0])
    return [out[k * N:(k + 1) * N] for k in range(len(blocks))]


@pytest.fixture(scope="module")
def references():
    """{(fmt, leaf, variant): ((8, N) words, {W: the reference's result on
    the first W workers' rows})}."""
    out = {}
    for i, (fmt, leaf) in enumerate(PAIRS):
        for j, variant in enumerate(("fpisa_a", "full")):
            words = _leaf_words(fmt, leaf, max(WORKERS), 10 * i + j)
            wants = _reference([words[:w] for w in WORKERS], fmt, leaf, variant)
            out[fmt, leaf, variant] = (words, dict(zip(WORKERS, wants)))
    return out


@pytest.mark.parametrize("fmt,leaf,w,variant", CASES, ids=IDS)
def test_plain_leaf_mode_equals_the_reference(references, fmt, leaf, w, variant):
    words, wants = references[fmt, leaf, variant]
    x = _torch(words[:w].copy(), leaf)
    want = wants[w]
    got = ref.accum_leaf_ref(x, variant, tf.FORMATS[fmt])
    assert got.dtype == TDT[leaf] and got.shape == (N,)
    np.testing.assert_array_equal(_bits(got), want)
    np.testing.assert_array_equal(_bits(ops.accum_leaf(x, variant, fmt)), want)


def test_the_edges_are_reached():
    """The inputs hit what they are written for: overwrites and register
    wraps in FPISA-A, and results that are inf only after the cast back."""
    words = _leaf_words("fp32", "bf16", 3, 0)
    x = _torch(words, "bf16")
    _, stats = tf.fpisa_sum_sequential(x, tf.FP32, return_stats=True)
    assert int(stats["overwrite"]) > 0 and int(stats["overflow"]) > 0
    for leaf, w in (("bf16", 3), ("fp16", 2)):
        x = _torch(_leaf_words("fp32", leaf, w, 1), leaf)
        wide = tf.fpisa_sum_sequential(x, tf.FP32)[5:7]
        assert torch.isfinite(wide).all() and torch.isinf(wide.to(x.dtype)).all()


def test_leaf_mode_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="widens"):
        ops.accum_leaf(torch.zeros((2, 8), dtype=torch.float32), fmt_name="bf16")
    with pytest.raises(ValueError, match="widens"):
        ops.accum_leaf(torch.zeros((2, 8), dtype=torch.bfloat16), fmt_name="fp16")
    before = (ops.accum.launches, dict(ops.accum.launches_by_mode))
    ops.accum_leaf(torch.zeros((2, 8), dtype=torch.bfloat16), fmt_name="fp32")
    assert (ops.accum.launches, ops.accum.launches_by_mode) == before  # the CPU launches nothing


# ---------------------------------------------------------------------------
# the kernel's per-element arithmetic, compiled for the host
# ---------------------------------------------------------------------------

HARNESS = r"""
#include "fpisa_fused.cuh"
using namespace fpisa;

template <class F, int Din, int Dout, bool kFull>
static void accum(const void* xv, void* outv, long n, int workers) {
  const typename Bits<Din>::T* x = static_cast<const typename Bits<Din>::T*>(xv);
  typename Bits<Dout>::T* out = static_cast<typename Bits<Dout>::T*>(outv);
  for (long i = 0; i < n; ++i) {
    Plane acc{0, 0};
    for (int w = 0; w < workers; ++w)
      acc = accum_add<F, kFull>(acc, encode<F>(widen<F, Din>(x[w * n + i])));
    out[i] = (typename Bits<Dout>::T)accum_out<F, Dout>(acc);
  }
}

template <class F, int Din, int Dout>
static int by_variant(int full, const void* x, void* o, long n, int w) {
  if (full) accum<F, Din, Dout, true>(x, o, n, w);
  else accum<F, Din, Dout, false>(x, o, n, w);
  return 0;
}

// renormalize_lean against renormalize: the mismatches over the exponents
// es[0..ne) and the summed mantissas ms[0..n)
template <class F>
static long renorm_mismatches(const int32_t* es, long ne, const int32_t* ms, long n) {
  long bad = 0;
  for (long j = 0; j < ne; ++j)
    for (long i = 0; i < n; ++i)
      bad += renormalize<F>(es[j], ms[i]) != renormalize_lean<F>(es[j], ms[i]);
  return bad;
}

extern "C" long host_renorm_mismatches(int fmt, const int32_t* es, long ne, const int32_t* ms,
                                       long n) {
  return fmt == 0   ? renorm_mismatches<Fp32>(es, ne, ms, n)
         : fmt == 1 ? renorm_mismatches<Fp16>(es, ne, ms, n)
                    : renorm_mismatches<Bf16>(es, ne, ms, n);
}

// local: float32 out (the TPU kernel's), else the leaf's dtype (leaf mode)
extern "C" int host_accum(int fmt, int dtype, int local, int full, const void* x, void* o,
                          long n, int w) {
  if (fmt == 0 && dtype == 0) return by_variant<Fp32, 0, 0>(full, x, o, n, w);
  if (fmt == 0 && dtype == 1) return by_variant<Fp32, 1, 1>(full, x, o, n, w);
  if (fmt == 0 && dtype == 2) return by_variant<Fp32, 2, 2>(full, x, o, n, w);
  if (fmt == 1 && dtype == 1 && local) return by_variant<Fp16, 1, 0>(full, x, o, n, w);
  if (fmt == 1 && dtype == 1) return by_variant<Fp16, 1, 1>(full, x, o, n, w);
  if (fmt == 2 && dtype == 2 && local) return by_variant<Bf16, 2, 0>(full, x, o, n, w);
  if (fmt == 2 && dtype == 2) return by_variant<Bf16, 2, 2>(full, x, o, n, w);
  return 1;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The header's K6 arithmetic built with the host's C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler builds the header's arithmetic"
    d = tmp_path_factory.mktemp("accum_header")
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(d / "harness.so"), str(d / "harness.cpp")], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(d / "harness.so"))
    lib.host_accum.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + \
        [ctypes.c_long, ctypes.c_int]
    lib.host_renorm_mismatches.argtypes = [ctypes.c_int] + [ctypes.c_void_p, ctypes.c_long] * 2
    lib.host_renorm_mismatches.restype = ctypes.c_long
    return lib


@pytest.mark.parametrize("fmt", ["fp32", "fp16", "bf16"])
def test_branch_free_renormalize_equals_renormalize(host_lib, fmt):
    """K6's renormalize_lean gives renormalize's bits for the int32
    register's edges, every power of two and its neighbours of both signs
    (the carry of a negative sum's floor), and random registers of every
    width, at every exponent within 40 of 0 and of the all-ones field (the
    normalizing shift moves an exponent by -23..25, so every under- and
    overflow edge lies there) and at every 25th from -300 to 300."""
    rng = np.random.default_rng(7)
    top = tf.FORMATS[fmt].exp_mask
    es = np.unique(np.concatenate([np.arange(-300, 301, 25), np.arange(-40, 41),
                                   np.arange(top - 40, top + 41)])).astype(np.int32)
    edges = [0, 1, -1, -2**31, 2**31 - 1, -2**31 + 1]
    for b in range(31):
        v = 1 << b
        edges += [v, -v, v - 1, 1 - v, v + 1, -v - 1, 2 * v - 1, 1 - 2 * v]
    rand = rng.integers(-2**31, 2**31, 20000, dtype=np.int64) >> rng.integers(0, 32, 20000)
    ms = np.concatenate([np.array(edges, np.int64), rand]).astype(np.int32)
    assert host_lib.host_renorm_mismatches(fpisa_fused.FMT_CODES[fmt], es.ctypes.data,
                                           es.size, ms.ctypes.data, ms.size) == 0


HOST_CASES = [(fmt, leaf, w) for fmt, leaf in PAIRS for w in (1, 3, 8)]


@pytest.mark.parametrize("fmt,leaf,w", HOST_CASES, ids=[f"{f}-{l}-W{w}" for f, l, w in HOST_CASES])
def test_header_arithmetic_equals_the_plain_versions(host_lib, fmt, leaf, w):
    """Leaf mode, and local mode where the leaf is the format's dtype, both
    variants: the header's add and output, per element, give the plain
    versions' bits."""
    x = _torch(_leaf_words(fmt, leaf, w, 500 + HOST_CASES.index((fmt, leaf, w))), leaf)
    codes, f = fpisa_fused.FMT_CODES, tf.FORMATS[fmt]
    for full, variant in enumerate(("fpisa_a", "full")):
        modes = [(0, TDT[leaf], ref.accum_leaf_ref(x, variant, f))]
        if leaf == fmt:
            modes.append((1, torch.float32, ops.accum(x[:, None], variant, fmt)[0]))
        for local, dtype, want in modes:
            out = torch.empty(N, dtype=dtype)
            assert host_lib.host_accum(codes[fmt], codes[leaf], local, full, x.data_ptr(),
                                       out.data_ptr(), N, w) == 0
            np.testing.assert_array_equal(_bits(out), _bits(want))


# ---------------------------------------------------------------------------
# fpisa_seq on two gloo ranks, gathered in the leaf's dtype
# ---------------------------------------------------------------------------

# (leaf dtype, format): widened in the kernel, and staged first (fp32 under
# bf16, bf16 under fp16)
GLOO_CASES = [("bf16", "fp32"), ("fp16", "fp32"), ("bf16", "bf16"), ("fp32", "fp32"),
              ("fp32", "bf16"), ("bf16", "fp16")]

GLOO_CODE = """
import os, numpy as np, torch, torch.distributed as dist
from repro_torch.core import allreduce
from repro_torch.core.agg import AggConfig, Aggregator
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method={init!r}, rank=rank, world_size=2)
TDT = {{"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}}
INT = {{"fp32": torch.int32, "fp16": torch.int16, "bf16": torch.int16}}
inp = np.load({inp!r})
gathered = []
gather = allreduce._all_gather_rows
def spy(flat, group):
    gathered.append(str(flat.dtype))
    return gather(flat, group)
allreduce._all_gather_rows = spy
res = {{}}
for backend in ("torch", "cuda"):
    if backend == "cuda":  # the cuda backend's path: ops on CPU tensors take the plain versions
        allreduce.resolve_backend = lambda backend, device: "cuda"
    for name in inp.files:
        leaf, fmt = name.split("-")
        x = torch.from_numpy(inp[name][rank]).view(INT[leaf]).view(TDT[leaf])  # (2, N)
        cfg = AggConfig(strategy="fpisa_seq", fmt_name=fmt, backend="torch")
        del gathered[:]
        flat = Aggregator(cfg).allreduce(x[0])
        stacked = Aggregator(cfg, stacked=True).allreduce(x)
        res[backend + "/flat/" + name] = flat.view(INT[leaf]).numpy()
        res[backend + "/stacked/" + name] = stacked.view(INT[leaf]).numpy()
        res[backend + "/gathered/" + name] = np.array(gathered)
np.savez(os.environ["OUT"], **res)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def gloo_procs(tmp_path_factory):
    """The two gloo ranks, started with the module's first test (they import
    torch while the other tests run); the inputs: per case a (2 ranks, k =
    2, N) stack of words."""
    tmp = tmp_path_factory.mktemp("seq_leaf")
    inp = {f"{leaf}-{fmt}": _leaf_words(fmt, leaf, 4, 900 + i).reshape(2, 2, N)
           for i, (leaf, fmt) in enumerate(GLOO_CASES)}
    np.savez(tmp / "in.npz", **inp)
    code = GLOO_CODE.format(init=f"file://{tmp}/pg", inp=str(tmp / "in.npz"))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=dict(env, RANK=str(r), OUT=str(tmp / f"r{r}.npz")))
             for r in range(2)]
    yield inp, tmp, procs
    for p in procs:
        if p.poll() is None:  # a failed test left it running
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def gloo_runs(gloo_procs):
    """Both ranks' results, waited for."""
    inp, tmp, procs = gloo_procs
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    return inp, [dict(np.load(tmp / f"r{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("leaf,fmt", GLOO_CASES, ids=[f"{l}-{f}" for l, f in GLOO_CASES])
def test_two_rank_fpisa_seq_gathers_the_leaf_and_equals_the_reference(gloo_runs, leaf, fmt):
    inp, ranks = gloo_runs
    name = f"{leaf}-{fmt}"
    words = inp[name]
    # per leaf, worker d is rank d's leaf; stacked, the workers are rank-major
    flat_want, stacked_want = _reference([words[:, 0], words.reshape(4, N)], fmt, leaf,
                                         "fpisa_a")
    staged = leaf if fpisa_fused.widens(TDT[leaf], fmt) else fmt
    want_dtype = str(TDT[staged])
    for res in ranks:
        for backend in ("torch", "cuda"):
            np.testing.assert_array_equal(res[f"{backend}/flat/{name}"], flat_want)
            np.testing.assert_array_equal(res[f"{backend}/stacked/{name}"], stacked_want)
            assert list(res[f"{backend}/gathered/{name}"]) == [want_dtype] * 2
