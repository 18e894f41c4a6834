"""O1 (``kernels/adamw.py``, ``csrc/adamw.cu``): AdamW's clip and update as
two CUDA kernels over a whole parameter tree, and ``optimizers.update``'s
choice between O1 and the eager route (``optimizers.update_eager``).

On the CPU: the route that ``update`` takes for each kind of tree (with
the leaves counted as the card's, O1 for AdamW over contiguous leaves of
bf16 or float32 p and g, and a ValueError naming a non-contiguous, float16
or subclassed leaf; the eager route's bits for ``sgdm`` and CPU leaves);
which local tensors O1 takes of a tree of DTensors, and which rank's shard
of a leaf enters the norm over a mesh.

On the card (marked ``cuda``; they skip elsewhere): O1 against the eager
route on the same CUDA tensors. With the clip inactive m, v, p and lr equal
bit for bit over 3 steps, on trees of ragged, 1-element, float32, mixed,
float32-gradient, unaligned and many-tiled leaves and on a tree of more
leaves than one launch's table holds; with the clip active grad_norm within
1e-6 and p within one bf16 step; lr and the bias corrections bit for bit at
steps 1-300; two runs repeat their bits; two launches a step whatever the
number of leaves up to ``MAX_LEAVES``, no synchronize and no host-to-device
copy; a refused leaf raises and launches nothing; on a one-rank (1, 1)
DeviceMesh O1 over DTensors gives the plain tree's bits with the clip
active. They import nothing of JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_adamw.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import adamw  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
INACTIVE = 1e9  # a grad_clip that no test gradient's norm reaches: the scale is 1


def _tree(shapes, dtypes, seed, device, grad_scale=1e-2):
    """(params, grads, state after one eager step's worth of moments) of
    numpy-seeded values; ``dtypes`` one per leaf."""
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    params = [draw(s).to(device=device, dtype=d) for s, d in zip(shapes, dtypes)]
    grads = [draw(s, grad_scale).to(device=device, dtype=d) for s, d in zip(shapes, dtypes)]
    m = [draw(s, 1e-3).to(device) for s in shapes]
    v = [draw(s, 1e-3).abs().square().to(device) for s in shapes]
    return params, grads, optimizers.OptState(step=0, m=m, v=v)


def _copy(t):
    """A copy of ``t``; of a contiguous ``t`` at the same offset into its
    storage, so a leaf off 16 bytes stays off."""
    if not t.is_contiguous():
        return t.clone()
    at = t.storage_offset()
    return torch.empty(at + t.numel(), dtype=t.dtype, device=t.device)[at:].view(t.shape) \
        .copy_(t)


def _clone(params, state):
    v = None if state.v is None else [_copy(t) for t in state.v]
    return [_copy(p) for p in params], state._replace(m=[_copy(t) for t in state.m], v=v)


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _same_bits(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(_bits(a), _bits(b)), f"{what}: the bits differ"


# --- the route, on the CPU --------------------------------------------------


class _Sub(torch.Tensor):
    """A tensor subclass that is not a DTensor: O1 refuses it."""


def _route_tree(case):
    shapes = [(4, 6), (10,), (3, 5)]
    dtypes = [BF16, F32, BF16] if case != "float16" else [torch.float16] * 3
    params, grads, state = _tree(shapes, dtypes, 0, "cpu")
    if case == "non_contiguous":
        params[0] = params[0].t().contiguous().t()
    elif case == "mixed_dtype":
        grads[0] = grads[0].float()
    elif case == "subclass":
        grads[1] = torch.Tensor._make_subclass(_Sub, grads[1])
    return params, grads, state


# case -> the optimizer, and what update does when the leaves' device counts
# as the card: O1, the eager route, or a ValueError that names the leaf
ROUTES = {"plain": ("adamw", "o1"), "sgdm": ("sgdm", "eager"),
          "non_contiguous": ("adamw", "leaf 0"), "mixed_dtype": ("adamw", "o1"),
          "float16": ("adamw", "leaf 0"), "subclass": ("adamw", "leaf 1")}


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "as_if_card"])
@pytest.mark.parametrize("case", list(ROUTES))
def test_update_takes_o1_only_for_plain_adamw_trees(case, on_card, monkeypatch):
    """``update`` runs O1 for AdamW on the card, over leaves of bf16 or
    float32 p and g, and refuses by name a leaf O1 cannot take; ``sgdm``
    and CPU leaves run ``update_eager``, with its bits. ``as_if_card`` lets
    the CPU leaves count as the card's (the kernels' launch replaced), so
    that each other condition decides alone; ``cpu`` keeps the device
    check."""
    name, route = ROUTES[case]
    route = route if on_card else "eager"
    cfg = optimizers.OptConfig(name=name, lr=1e-2, warmup_steps=3)
    params, grads, state = _route_tree(case)
    if name == "sgdm":
        state = state._replace(v=None)
    calls = []

    def launch(tables, partials, gnorm, lr, step, cfg, stream):
        calls.append(step)
        gnorm.fill_(0.5)
        lr.fill_(0.25)

    monkeypatch.setattr(adamw, "adamw_norm", lambda tables, partials, stream: None)
    monkeypatch.setattr(adamw, "adamw_update", launch)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type("S", (), {"cuda_stream": 0}))
    if on_card:
        monkeypatch.setattr(adamw, "on_card", lambda params: True)
    want_p, want_state = _clone(params, state)
    if route.startswith("leaf"):
        with pytest.raises(ValueError, match=f"cannot take {route} "):
            optimizers.update(params, grads, state, cfg)
        assert calls == []
        return
    new, met = optimizers.update(params, grads, state, cfg)
    assert new.step == 1
    if route == "o1":
        assert calls == [1] and float(met["grad_norm"]) == 0.5 and float(met["lr"]) == 0.25
        return
    assert calls == []
    ref, ref_met = optimizers.update_eager(want_p, grads, want_state, cfg)
    for a, b in zip(params + new.m + (new.v or []), want_p + ref.m + (ref.v or [])):
        _same_bits(a, b, case)
    for k in ("grad_norm", "lr"):
        _same_bits(met[k], ref_met[k], k)


def test_takes_refuses_cpu_leaves_and_uneven_trees():
    params, grads, state = _tree([(3,), (2, 2)], [BF16, BF16], 1, "cpu")
    assert not adamw.on_card(params)
    p, g, m, v, in_norm, mesh = adamw.local_tree(params, grads, state.m, state.v)
    assert p == params and g == grads and in_norm == [True, True] and mesh is None
    for args in ((params, grads[:1], state.m, state.v), ([], [], [], [])):
        with pytest.raises(ValueError, match="AdamW's tree"):
            adamw.local_tree(*args)
    with pytest.raises(ValueError, match="leaf 1 .* shapes"):
        adamw.local_tree(params, [grads[0], grads[1].reshape(4)], state.m, state.v)


def test_dtensor_shards_enter_the_norm_once_over_the_mesh():
    """A leaf's shard enters the norm on the rank at coordinate 0 of every
    axis it is replicated over; an axis of one rank lays out as
    ``Replicate``, so ZeRO-1's moments there lie as their parameter does."""
    from torch.distributed.tensor import Replicate, Shard

    R, S0, S1 = Replicate(), Shard(0), Shard(1)
    assert adamw._layout((S0, S1), (1, 4)) == (R, S1)
    assert adamw._layout((S0, R), (2, 4)) == (S0, R)
    cases = {((R, R), (0, 0)): True, ((R, R), (1, 0)): False, ((R, S1), (0, 3)): True,
             ((R, S1), (1, 3)): False, ((S0, S1), (1, 3)): True, ((S0, R), (1, 2)): False}
    for (pls, coord), want in cases.items():
        assert adamw._in_norm(pls, coord) is want, (pls, coord)
    # over a (2, 4) mesh each element of each layout is counted once
    for pls in ((R, R), (R, S1), (S0, R), (S0, S1)):
        shards = {(a if isinstance(pls[0], Shard) else 0, b if isinstance(pls[1], Shard) else 0)
                  for a in range(2) for b in range(4) if adamw._in_norm(pls, (a, b))}
        assert len(shards) == (2 if pls[0] != R else 1) * (4 if pls[1] != R else 1), pls


def test_dtensor_tree_on_one_rank_gives_its_local_shards(tmp_path):
    """On a one-rank gloo group's (data, model) = (1, 1) mesh, AdamW's
    ZeRO-1 layout (m and v sharded over 'data', p and g replicated) gives
    the local tensors, every leaf in the norm, and the mesh, over which the
    partials' sum is their own; a tree whose grads are plain refuses its
    first leaf."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        params, grads, state = _tree([(4, 6), (8,)], [BF16, F32], 2, "cpu")

        def place(ts, pls):
            return [DTensor.from_local(t, mesh, pls, run_check=False) for t in ts]

        rep, zero1 = [Replicate(), Replicate()], [Shard(0), Replicate()]
        tree = (place(params, rep), place(grads, rep), place(state.m, zero1),
                place(state.v, zero1))
        *local, in_norm, got_mesh = adamw.local_tree(*tree)
        for got, want in zip(local, (params, grads, state.m, state.v)):
            assert [t.data_ptr() for t in got] == [t.data_ptr() for t in want]
            assert all(type(t) is torch.Tensor for t in got)
        assert in_norm == [True, True] and got_mesh is mesh
        partials = torch.arange(6, dtype=torch.float64)
        assert torch.equal(adamw._sum_over(mesh, partials), partials)
        with pytest.raises(ValueError, match="leaf 0 .* DTensor"):
            adamw.local_tree(tree[0], grads, *tree[2:])
    finally:
        dist.destroy_process_group()


# --- O1 on the card ---------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (O1 has no CPU mode)")
    return torch.device("cuda")


def _run(params, grads_by_step, state, cfg, route):
    """``route`` (update or update_eager) over the steps' gradients from a
    copy of (params, state): -> (params, state, [metrics])."""
    params, state = _clone(params, state)
    mets = []
    for grads in grads_by_step:
        state, met = route(params, grads, state, cfg)
        mets.append(met)
    torch.cuda.synchronize()
    return params, state, mets


def _grads(shapes, dtypes, steps, dev, scale=1e-2):
    return [_tree(shapes, dtypes, 100 + i, dev, scale)[1] for i in range(steps)]


def _launches():
    return adamw.adamw_norm.launches, adamw.adamw_update.launches


def _assert_o1_equals_eager(shapes, dtypes, dev, steps=3, params=None, grad_dtypes=None):
    cfg = optimizers.OptConfig(lr=1e-2, grad_clip=INACTIVE, warmup_steps=2)
    p0, _, state = _tree(shapes, dtypes, 7, dev)
    params = p0 if params is None else params
    grads = _grads(shapes, grad_dtypes or dtypes, steps, dev)
    before = _launches()
    got_p, got_s, got_m = _run(params, grads, state, cfg, optimizers.update)
    groups = -(-len(shapes) // adamw.MAX_LEAVES)
    assert _launches() == (before[0] + groups * steps, before[1] + groups * steps)
    want_p, want_s, want_m = _run(params, grads, state, cfg, optimizers.update_eager)
    assert _launches() == (before[0] + groups * steps, before[1] + groups * steps)
    for i, (a, b) in enumerate(zip(got_p, want_p)):
        _same_bits(a, b, f"param {i} {tuple(a.shape)}")
    for i, (a, b) in enumerate(zip(got_s.m + got_s.v, want_s.m + want_s.v)):
        _same_bits(a, b, f"moment {i}")
    for a, b in zip(got_m, want_m):
        _same_bits(a["lr"], b["lr"], "lr")
        assert a["grad_norm"].shape == () and a["grad_norm"].is_cuda
        torch.testing.assert_close(a["grad_norm"], b["grad_norm"], rtol=1e-6, atol=0)
    assert got_s.step == want_s.step == steps


# a qwen-like tree of 14 leaves at a small width, bf16
QWEN_LIKE = [(2000, 64), (24, 64), (24, 64, 192), (24, 192), (24, 64, 64), (24, 64),
             (24, 64, 176), (24, 64, 176), (24, 176, 64), (24, 64), (64,), (24, 192, 3),
             (7,), (1,)]


@pytest.mark.cuda
def test_o1_equals_eager_bit_for_bit_with_the_clip_inactive(dev):
    _assert_o1_equals_eager(QWEN_LIKE, [BF16] * len(QWEN_LIKE), dev)


# leaf sizes: 1 element, ragged against the vector (4) and the tile (2048),
# a leaf of many tiles a CTA (past the norm's 1024 CTAs x 2048); a third
# entry gives the grads' dtypes where they are not the params'
EDGE_TREES = {
    "ragged": ([(1,), (3,), (5, 7), (2047,), (2049,), (4099,), (13, 315)], [BF16] * 7),
    "float32": ([(1,), (6,), (33, 65), (4096,)], [F32] * 4),
    "mixed": ([(5,), (2050,), (9, 9), (1,)], [BF16, F32, F32, BF16]),
    "grad_dtypes": ([(5,), (2050,), (9, 9), (1,)], [BF16, BF16, F32, BF16],
                    [F32, F32, BF16, BF16]),
    "many_tiles": ([(2_400_011,), (3,)], [BF16, BF16]),
    "groups": ([(i % 9 + 1, 37) for i in range(adamw.MAX_LEAVES + 6)],
               [BF16, F32] * ((adamw.MAX_LEAVES + 6) // 2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tree", list(EDGE_TREES))
def test_o1_equals_eager_on_edge_trees(dev, tree):
    shapes, dtypes, *grad_dtypes = EDGE_TREES[tree]
    _assert_o1_equals_eager(shapes, dtypes, dev, grad_dtypes=(grad_dtypes or [None])[0])


@pytest.mark.cuda
def test_o1_equals_eager_on_leaves_off_16_bytes(dev):
    """Contiguous leaves that start 2 or 4 bytes into their storage take the
    kernels' element-by-element path."""
    shapes, dtypes = [(9, 13), (1030,), (4,)], [BF16, F32, BF16]
    p0, _, _ = _tree(shapes, dtypes, 7, dev)
    params = [torch.empty(p.numel() + 1, dtype=p.dtype, device=dev)[1:].view(p.shape).copy_(p)
              for p in p0]
    assert all(p.is_contiguous() and p.data_ptr() % 16 for p in params)
    assert all(q.data_ptr() % 16 for q in _clone(params, optimizers.OptState(0, [], []))[0])
    _assert_o1_equals_eager(shapes, dtypes, dev, params=params)


def _ordered(t):
    """A bf16 tensor's bits as integers in the order of the values."""
    i = t.view(torch.int16).int()
    return torch.where(i < 0, -32768 - i, i)


@pytest.mark.cuda
def test_o1_with_the_clip_active_within_a_bf16_step(dev):
    cfg = optimizers.OptConfig(lr=1e-2, grad_clip=1.0, warmup_steps=2)
    params, _, state = _tree(QWEN_LIKE, [BF16] * len(QWEN_LIKE), 7, dev)
    grads = _grads(QWEN_LIKE, [BF16] * len(QWEN_LIKE), 1, dev, scale=1.0)
    got_p, got_s, (got,) = _run(params, grads, state, cfg, optimizers.update)
    want_p, want_s, (want,) = _run(params, grads, state, cfg, optimizers.update_eager)
    assert float(want["grad_norm"]) > 100 * cfg.grad_clip  # the clip scales every gradient
    torch.testing.assert_close(got["grad_norm"], want["grad_norm"], rtol=1e-6, atol=0)
    _same_bits(got["lr"], want["lr"], "lr")
    for a, b in zip(got_p, want_p):
        assert int((_ordered(a) - _ordered(b)).abs().max()) <= 1
    for a, b in zip(got_s.m + got_s.v, want_s.m + want_s.v):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6 * float(b.abs().max()))


@pytest.mark.cuda
def test_o1_schedule_and_bias_corrections_bit_for_bit_at_steps_1_to_300(dev):
    """lr compared directly; c1 and c2 through p: from p = 0 and g = 0 the
    update writes -lr * (m / c1) / (sqrt(v / c2) + eps), over 4,096 moments
    of many magnitudes."""
    cfg = optimizers.OptConfig(lr=3e-4, grad_clip=1.0, warmup_steps=100)
    rng = np.random.default_rng(3)
    m0 = torch.from_numpy((rng.standard_normal(4096) * np.exp2(rng.integers(-20, 0, 4096)))
                          .astype(np.float32)).to(dev)
    v0 = torch.from_numpy(np.exp2(rng.uniform(-40, -2, 4096)).astype(np.float32)).to(dev)
    zero = torch.zeros(4096, dtype=F32, device=dev)
    for step in range(1, 301):
        out = []
        for route in (optimizers.update, optimizers.update_eager):
            p, m, v = zero.clone(), m0.clone(), v0.clone()
            state, met = route([p], [zero], optimizers.OptState(step - 1, [m], [v]), cfg)
            out.append((p, m, v, met["lr"]))
        for a, b, what in zip(out[0], out[1], ("p", "m", "v", "lr")):
            _same_bits(a, b, f"step {step}: {what}")


@pytest.mark.cuda
def test_o1_repeats_its_bits(dev):
    cfg = optimizers.OptConfig(lr=1e-2, grad_clip=1.0, warmup_steps=2)
    shapes, dtypes, *_ = EDGE_TREES["many_tiles"]
    params, _, state = _tree(shapes, dtypes, 7, dev)
    grads = _grads(shapes, dtypes, 2, dev, scale=1.0)
    a_p, a_s, a_m = _run(params, grads, state, cfg, optimizers.update)
    b_p, b_s, b_m = _run(params, grads, state, cfg, optimizers.update)
    for a, b in zip(a_p + a_s.m + a_s.v, b_p + b_s.m + b_s.v):
        _same_bits(a, b, "a repeated run")
    for a, b in zip(a_m, b_m):
        _same_bits(a["grad_norm"], b["grad_norm"], "grad_norm")


@pytest.mark.cuda
@pytest.mark.parametrize("leaves", [14, 22, adamw.MAX_LEAVES])
def test_o1_launches_two_kernels_a_step(dev, leaves):
    shapes = [(i + 1, 3) for i in range(leaves)]
    params, grads, state = _tree(shapes, [BF16] * leaves, 0, dev)
    before = _launches()
    for _ in range(2):
        state, _ = optimizers.update(params, grads, state, optimizers.OptConfig())
    assert _launches() == (before[0] + 2, before[1] + 2)


@pytest.mark.cuda
def test_o1_neither_synchronizes_nor_copies_from_the_host(dev):
    """Under ``set_sync_debug_mode("error")`` a synchronizing call raises,
    a blocking host-to-device copy among them: O1 runs through, the eager
    route (its step's scalars, ``_f32``) raises."""
    params, grads, state = _tree(QWEN_LIKE, [BF16] * len(QWEN_LIKE), 0, dev)
    cfg = optimizers.OptConfig()
    state, _ = optimizers.update(params, grads, state, cfg)  # builds and warms
    torch.cuda.synchronize()
    before = _launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = optimizers.update(params, grads, state, cfg)
        with pytest.raises(RuntimeError, match="synchroniz"):
            optimizers.update_eager(params, grads, state, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _launches() == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_eager_route_on_the_card_for_what_o1_does_not_take(dev):
    """On the card ``sgdm`` runs the eager route; AdamW over a leaf O1
    cannot take raises a ValueError that names it, and launches nothing."""
    params, grads, state = _tree([(6, 4), (5,)], [BF16, BF16], 0, dev)
    before = _launches()
    optimizers.update(params, grads, state._replace(v=None), optimizers.OptConfig(name="sgdm"))
    refused = {"non_contiguous": ([params[0].t(), params[1]], [grads[0].t(), grads[1]],
                                  state._replace(m=[state.m[0].t(), state.m[1]],
                                                 v=[state.v[0].t(), state.v[1]])),
               "float16": ([params[0], params[1].half()], [grads[0], grads[1].half()], state),
               "cpu_leaf": ([params[0], params[1].cpu()], grads, state)}
    for case, (p, g, s) in refused.items():
        with pytest.raises(ValueError, match="leaf [01] "):
            optimizers.update(p, g, s, optimizers.OptConfig())
    assert _launches() == before


@pytest.mark.cuda
def test_o1_on_dtensor_shards_equals_plain_bit_for_bit(dev, tmp_path):
    """On a one-rank NCCL group's (data, model) = (1, 1) DeviceMesh, with
    AdamW's ZeRO-1 layout (m and v ``Shard(0)`` over 'data', p and g
    replicated): ``update`` over the DTensors runs O1 on their local shards,
    two launches a step, and gives the plain tree's bits over 3 steps with
    the clip active; grad_norm and lr are plain tensors on the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    cfg = optimizers.OptConfig(lr=1e-2, grad_clip=1.0, warmup_steps=2)
    shapes, dtypes = QWEN_LIKE, [BF16] * len(QWEN_LIKE)
    params, _, state = _tree(shapes, dtypes, 7, dev)
    grads = _grads(shapes, dtypes, 3, dev, scale=1.0)
    want_p, want_s, want_m = _run(params, grads, state, cfg, optimizers.update)
    assert not dist.is_initialized()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        rep, zero1 = [Replicate(), Replicate()], [Shard(0), Replicate()]

        def place(ts, pls):
            return [DTensor.from_local(t, mesh, pls, run_check=False) for t in ts]

        got_p, got_s = _clone(params, state)
        got_p = place(got_p, rep)
        got_s = got_s._replace(m=place(got_s.m, zero1), v=place(got_s.v, zero1))
        before = _launches()
        got_m = []
        for g in grads:
            got_s, met = optimizers.update(got_p, place(g, rep), got_s, cfg)
            got_m.append(met)
        torch.cuda.synchronize()
        assert _launches() == (before[0] + 3, before[1] + 3)
        for a, b in zip(got_p + got_s.m + got_s.v, want_p + want_s.m + want_s.v):
            _same_bits(a.to_local(), b, "a DTensor leaf")
        for a, b in zip(got_m, want_m):
            for k in ("grad_norm", "lr"):
                assert type(a[k]) is torch.Tensor and a[k].is_cuda
                _same_bits(a[k], b[k], k)
    finally:
        dist.destroy_process_group()


def test_kernel_constants_match_the_source():
    """The wrapper's constants are those ``csrc/adamw.cu`` states."""
    text = (Path(adamw.__file__).parent.parent / "csrc" / "adamw.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert (consts["kMaxLeaves"], consts["kNormCtas"], consts["kFields"]) == \
        (adamw.MAX_LEAVES, adamw.NORM_CTAS, adamw.FIELDS)
    assert (consts["kParamF32"], consts["kAligned"], consts["kGradF32"]) == \
        (adamw.PARAM_F32, adamw.ALIGNED, adamw.GRAD_F32)
