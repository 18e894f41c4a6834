"""Pipeline parallelism: a GPipe-style microbatched stage loop over a stage
process group (torch port of ``repro.train.pipeline``).

The stacked layer parameters (L, ...) are split into ``n_stages`` contiguous
chunks along L (``split_stages``); stage i of the group holds chunk i. The
schedule runs m + n - 1 ticks for m microbatches: at tick t stage 0 injects
microbatch t, every stage runs its chunk on what entered it, sends the
result to stage i + 1 and receives stage i - 1's, and the last stage banks
its result for microbatch t - (n - 1). The banked outputs are then
broadcast from the last stage, so every stage computes the same logits and
loss.

The reference gets its backward for free (``ppermute`` is differentiable).
Here three autograd functions carry it:

* ``_shift``: forward sends to stage i + 1 and receives from i - 1
  (``dist.batch_isend_irecv``); backward sends the gradient back to i - 1
  and receives from i + 1.
* ``_from_last``: the broadcast, one all-reduce with a single nonzero term
  (exact); every stage holds the whole loss, so the gradient passes through
  unchanged and only the last stage's banked outputs receive it.
* ``_varying``: the embedding output enters the stream on stage 0 only;
  its gradient is summed over the stages (the reference's transpose of an
  invariant input used in a varying way), so the embedding, computed on
  every stage, gets the whole gradient on every stage.

Every tick's stream and bank go through ``torch.where`` (not Python
branches), as the reference's ``jnp.where`` does, so every stage's autograd
graph holds every tick's send and receive and the stages' backward
exchanges pair up. With these, every leaf's gradient is the plain model's:
the layer chunk on its stage, the replicated leaves (embedding, final norm,
head) whole on every stage, as the reference's ``jax.grad`` of its loss
gives them.

Scope: dense and vlm-family blocks (the families that benefit from depth);
embedding and head are computed on every stage, the pipeline carries the
residual stream only.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import dtype_of, embed, rms_norm
from repro_torch.models.transformer import _dense_block, _tree_map, unstack


def split_stages(params: dict, n_stages: int) -> dict:
    """Reshape stacked layer params (L, ...) -> (n_stages, L/n_stages, ...)."""
    def one(x):
        layers = x.shape[0]
        if layers % n_stages:
            raise ValueError(f"{layers} layers do not split into {n_stages} stages")
        return x.reshape(n_stages, layers // n_stages, *x.shape[1:])

    return dict(params) | {"layers": _tree_map(one, params["layers"])}


def param_tree(model: torch.nn.Module) -> dict:
    """The model's parameters as the reference's nested tree (the same
    tensors, so gradients reach the model's leaves)."""
    tree: dict = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p
    return tree


def _stage_fn(stage_layers: dict, x: torch.Tensor, cfg, positions) -> torch.Tensor:
    """The stage's chunk of layers, each layer's body recomputed in the
    backward (the reference's ``jax.checkpoint`` of its scan body)."""
    for lp in unstack(stage_layers):
        x = checkpoint(lambda y, lp=lp: _dense_block(lp, y, cfg, positions)[0], x,
                       use_reentrant=False)
    return x


def _peer(group, stage: int) -> int:
    return dist.get_global_rank(group, stage) if group is not None else stage


def _exchange(send: torch.Tensor | None, to: int | None, frm: int | None, group,
              like: torch.Tensor) -> torch.Tensor:
    """Send ``send`` to stage ``to`` and receive a tensor like ``like`` from
    stage ``frm`` (None: no such stage; zeros are received)."""
    out = torch.zeros_like(like)
    ops = []
    if to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), _peer(group, to), group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, out, _peer(group, frm), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, sid: int, n: int):
        ctx.group, ctx.sid, ctx.n = group, sid, n
        nxt = sid + 1 if sid + 1 < n else None
        prv = sid - 1 if sid > 0 else None
        return _exchange(y, nxt, prv, group, y)

    @staticmethod
    def backward(ctx, grad):
        sid, n = ctx.sid, ctx.n
        prv = sid - 1 if sid > 0 else None
        nxt = sid + 1 if sid + 1 < n else None
        return _exchange(grad, prv, nxt, ctx.group, grad), None, None, None


class _FromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        # one nonzero term (the last stage's), so the sum is exact in any order
        # repro-lint: disable=torch-bit-identity
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Varying(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        # the transpose of an input every stage holds (module doc); the stream enters on
        # stage 0 only, so one term is nonzero: exact, and not the gradient aggregation
        # repro-lint: disable=torch-bit-identity
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _stage_of(group) -> tuple[int, int]:
    """(n, sid) of this rank in the stage group (one stage without a
    process group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def pipeline_forward(params: dict, batch: dict, cfg, *, group, n_micro: int) -> torch.Tensor:
    """``params['layers']`` is this stage's chunk (L/n_stages, ...), the
    other parameters whole. Returns the logits of the full batch, the same
    on every stage."""
    n, sid = _stage_of(group)
    toks = batch["tokens"]
    b, s = toks.shape
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    mb = b // n_micro
    x_full = embed(params["embed"], toks).to(dtype_of(cfg.activation_dtype))
    if n > 1:
        x_full = _Varying.apply(x_full, group)
    micro = x_full.reshape(n_micro, mb, s, -1)
    positions = torch.arange(s, device=toks.device)
    first = torch.tensor(sid == 0, device=toks.device)
    stream = torch.zeros_like(micro[0])
    outputs = [torch.zeros_like(micro[0]) for _ in range(n_micro)]
    ticks = n_micro + n - 1
    for t in range(ticks):
        x_in = torch.where(first, micro[t if t < n_micro else 0], stream)
        y = _stage_fn(params["layers"], x_in, cfg, positions)
        if t + 1 < ticks:  # the last tick's send would be received by nobody's next tick
            stream = _Shift.apply(y, group, sid, n) if n > 1 else torch.zeros_like(y)
        out_idx = min(max(t - (n - 1), 0), n_micro - 1)
        bank = torch.tensor(t >= n - 1 and sid == n - 1, device=toks.device)
        outputs[out_idx] = torch.where(bank, y, outputs[out_idx])
    outputs = torch.stack(outputs)
    if n > 1:
        outputs = _FromLast.apply(outputs * float(sid == n - 1), group)
    x = rms_norm(outputs.reshape(b, s, -1), params["final_norm"]["w"], cfg.norm_eps)
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["head"]["w"]
    return x @ w


def make_pp_loss(cfg, mesh=None, stage_axis: str = "pod", n_micro: int = 4):
    """Returns ``loss_fn(params_staged, batch)``: the mean next-token NLL of
    the pipelined forward over the stage group, ``mesh[stage_axis]``'s
    group (a ``DeviceMesh``), or ``mesh`` itself as a process group (None:
    the default group, or one stage without one). ``params_staged`` is
    ``split_stages`` of the whole tree; each stage takes its chunk."""
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"pipeline stages run dense blocks; got family {cfg.family!r}")
    group = mesh[stage_axis].get_group() if hasattr(mesh, "mesh_dim_names") else mesh

    def loss(params_staged: dict, batch: dict) -> torch.Tensor:
        _, sid = _stage_of(group)
        params = dict(params_staged) | {
            "layers": _tree_map(lambda a: a[sid], params_staged["layers"])}
        logits = pipeline_forward(params, batch, cfg, group=group, n_micro=n_micro)
        lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
        nll = -lp.gather(-1, batch["tokens"][:, 1:, None].long())[..., 0]
        return nll.mean()

    return loss
