"""Logical-axis -> mesh-axis sharding rules (torch port of
``repro.sharding.rules``), and their DTensor placements.

A spec is a plain tuple with one entry per tensor dimension: None
(replicated), a mesh axis name, or a tuple of axis names (the dimension
split over several axes, major first). The rules are pure functions of a
leaf's path, its rank, the config and the mesh's axis sizes, so they take a
``DeviceMesh`` or a ``launch.mesh.MeshShape`` alike. A parameter's path is
its ``named_parameters()`` name with ``/`` for ``.`` (``layers.attn.wq`` is
the reference's ``layers/attn/wq``); a cache leaf's path is its place in the
port's cache tree (``kv/k``, ``self_kv/v``, ``cross_kv/0``, ``ssm``,
``conv``, ``pos``).

Mesh axes: ('pod',) 'data', 'model'.

Attention TP mode is chosen per architecture from divisibility against the
'model' axis size m:
  head  : H % m == 0 and K % m == 0     -> q,k,v sharded on their head axes
  qhead : H % m == 0 only               -> q sharded on heads, k/v weights
          replicated (Megatron-style KV duplication)
  hdim  : head_dim % m == 0             -> q,k,v sharded on head_dim
  none  : replicated attention weights.

MoE: experts over 'model', expert ff over 'data'; FSDP ('data' on embed
axes) turns on when cfg.dp_boundary == 'pod'. Optimizer m/v shard their
first free divisible axis over 'data' (ZeRO-1).

``placements(spec, mesh)`` turns a spec into one DTensor placement per mesh
dimension: ``Shard(dim)`` where the spec names that axis, else
``Replicate()``. ``distribute(model, cfg, mesh)`` replaces every parameter
of the model by a DTensor placed by its spec (the reference's
``rules.named`` + ``jax.device_put``), and AdamW's moments by DTensors
placed by ``opt_pspecs``.
"""
from __future__ import annotations

import re

import torch

from repro_torch.launch.mesh import mesh_shape


def attn_mode(cfg, model_size: int) -> str:
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if h == 0:
        return "none"
    if h % model_size == 0 and k % model_size == 0:
        return "head"
    if h % model_size == 0:
        return "qhead"
    if hd % model_size == 0:
        return "hdim"
    return "none"


def _div(n: int, size: int, axis="model"):
    return axis if n % size == 0 else None


def _param_spec(path: str, ndim: int, cfg, m: int, dsz: int) -> tuple:
    d = "data" if cfg.dp_boundary == "pod" else None  # FSDP
    am = attn_mode(cfg, m)

    def match(*pats):
        return any(re.search(p, path) for p in pats)

    if match(r"embed/tok"):
        return (_div(cfg.vocab_size, m), d)
    if match(r"head/w"):
        return (d, _div(cfg.vocab_size, m))
    if match(r"vlm_proj", r"frame_proj"):
        return (d, _div(cfg.d_model, m))
    if match(r"attn/wq$", r"xattn/wq$"):
        if am in ("head", "qhead"):
            return (d, "model", None)
        if am == "hdim":
            return (d, None, "model")
        return (d, None, None)
    if match(r"attn/w[kv]$", r"xattn/w[kv]$"):
        if am == "head":
            return (d, "model", None)
        if am == "hdim":
            return (d, None, "model")
        return (d, None, None)  # qhead: replicated KV (Megatron duplication)
    if match(r"attn/wo$", r"xattn/wo$"):
        if am in ("head", "qhead"):
            return ("model", None, d)
        if am == "hdim":
            return (None, "model", d)
        return (None, None, d)
    if match(r"attn/bq$", r"xattn/bq$"):
        return ("model" if am in ("head", "qhead") else None, None)
    if match(r"attn/b[kv]$", r"xattn/b[kv]$"):
        return ("model" if am == "head" else None, None)
    if match(r"moe/router"):
        return (d, None)
    if match(r"moe/wi$", r"moe/wg$"):
        return (_div(cfg.num_experts, m), None, _div(cfg.d_ff, dsz, "data"))
    if match(r"moe/wo$"):
        return (_div(cfg.num_experts, m), _div(cfg.d_ff, dsz, "data"), None)
    if match(r"dense_mlp/wi$", r"dense_mlp/wg$"):
        return (d, _div(cfg.moe_dense_ff, m))
    if match(r"dense_mlp/wo$"):
        return (_div(cfg.moe_dense_ff, m), d)
    if match(r"mlp/wi$", r"mlp/wg$"):
        return (d, _div(cfg.d_ff, m))
    if match(r"mlp/wo$"):
        return (_div(cfg.d_ff, m), d)
    conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    if match(r"mamba/in_proj"):
        return (d, _div(2 * cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
                        + cfg.ssm_heads, m))
    if match(r"mamba/out_proj"):
        return (_div(cfg.ssm_d_inner, m), d)
    if match(r"mamba/conv_w"):
        return (None, _div(conv_ch, m))
    if match(r"mamba/conv_b"):
        return (_div(conv_ch, m),)
    if match(r"mamba/norm_w"):
        return (_div(cfg.ssm_d_inner, m),)
    # small vectors: norms, a_log, dt_bias, d_skip
    return (None,) * ndim


_STACKED_RE = re.compile(r"(^|/)(layers|tail_layers|enc_layers|dec_layers)(/|$)")


def _spec(*parts) -> tuple:
    """A spec as ``PartitionSpec`` normalizes one: an axis tuple of one
    name is that name."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts)


def _drop_missing_axes(spec: tuple, mesh) -> tuple:
    """Null out mesh axes a rule names but this mesh doesn't have (e.g. a
    pure-DP mesh has no 'model' axis: those dims replicate)."""
    names = set(mesh_shape(mesh).axis_names)

    def keep(p):
        if isinstance(p, tuple):
            kept = tuple(a for a in p if a in names)
            return kept if kept else None
        return p if (p is None or p in names) else None

    return _spec(*(keep(p) for p in spec))


def tree_paths(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of a tree of dicts, NamedTuples, tuples and lists
    (NamedTuple fields by name, sequence items by index), in order; a
    module or a mapping of ``named_parameters()`` names gives its
    parameters with ``/`` for ``.``."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        items = [(str(k).replace(".", "/"), v) for k, v in tree.items()]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(tree_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def param_pspecs(params, cfg, mesh) -> dict:
    """{path: spec} for a model, a ``{name: tensor}`` mapping or a nested
    parameter tree (tensors of any device, ``meta`` included)."""
    shape = mesh_shape(mesh).shape
    m, dsz = shape.get("model", 1), shape.get("data", 1)
    specs = {}
    for path, leaf in tree_paths(params):
        extra = 0
        if _STACKED_RE.search(path):
            extra = 2 if (cfg.family == "hybrid" and path.startswith("layers/")) else 1
        spec = _param_spec(path, _ndim(leaf) - extra, cfg, m, dsz)
        specs[path] = _drop_missing_axes((None,) * extra + spec, mesh)
    return specs


def _flat_axes(parts) -> list:
    return [q for p in parts for q in ((p,) if not isinstance(p, tuple) else p)]


def opt_pspecs(param_specs: dict, params, mesh) -> dict:
    """AdamW m/v specs: 'data' on the first unsharded axis divisible by the
    data-axis size (ZeRO-1 memory layout)."""
    data = mesh_shape(mesh).shape.get("data", 1)
    leaves = dict(tree_paths(params))
    out = {}
    for path, spec in param_specs.items():
        shape = tuple(leaves[path].shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if "data" not in _flat_axes(parts):
            for i, p in enumerate(parts):
                if p is None and shape[i] % data == 0 and shape[i] >= data:
                    parts[i] = "data"
                    break
        out[path] = tuple(parts)
    return out


def batch_axes(mesh, batch_size: int) -> tuple:
    shape = mesh_shape(mesh).shape
    use, rem = [], batch_size
    for a in ("pod", "data"):
        if a in shape and rem % shape[a] == 0:
            use.append(a)
            rem //= shape[a]
    return tuple(use)


def batch_pspec(mesh, batch_size: int) -> tuple:
    use = batch_axes(mesh, batch_size)
    return _spec(use if use else None)


def input_pspecs(batch: dict, mesh, batch_size: int) -> dict:
    """Every batch input sharded on its leading (batch) axis."""
    spec = batch_pspec(mesh, batch_size)
    return {k: spec + (None,) * (_ndim(v) - 1) for k, v in batch.items()}


def cache_pspecs(cache, mesh, batch_size: int, cfg) -> dict:
    """{path: spec} of a serving cache. KV heads shard over 'model' when
    divisible; otherwise the cache *sequence* axis shards over 'model'
    (context-parallel decode). Batch shards over replica axes; for batch=1
    long-context the seq axis also takes 'data'."""
    shape = mesh_shape(mesh).shape
    m = shape.get("model", 1)
    b_axes = batch_axes(mesh, batch_size) or None
    kv_div = cfg.num_kv_heads and cfg.num_kv_heads % m == 0
    seq_parts = []
    if batch_size == 1 and "data" in shape:
        seq_parts.append("data")
    if not kv_div and "model" in shape and cfg.num_kv_heads:
        seq_parts.append("model")
    seq_spec = tuple(seq_parts) if seq_parts else None
    conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state

    def one(path, leaf):
        if _ndim(leaf) == 0:
            return ()
        if re.search(r"(^|/)(kv|self_kv)/[kv]$|cross_kv/[01]$", path):
            # (L, B, S, K, hd)
            return _spec(None, b_axes, seq_spec, "model" if kv_div else None, None)
        if re.search(r"(^|/)ssm$", path):
            # (L, B, H, P, N)
            return _spec(None, b_axes, _div(cfg.ssm_heads, m), None, None)
        if re.search(r"(^|/)conv$", path):
            return _spec(None, b_axes, None, _div(conv_ch, m))
        return ()

    return {path: one(path, leaf) for path, leaf in tree_paths(cache) if leaf is not None}


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: tuple, mesh) -> tuple:
    """One DTensor placement per dimension of ``mesh``: ``Shard(d)`` where
    tensor dimension d names that axis, else ``Replicate()``. Axes the mesh
    lacks are dropped first. A dimension split over several axes must name
    them in the mesh's order (DTensor splits it over mesh dimensions from
    the first to the last)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_shape(mesh).axis_names
    spec = _drop_missing_axes(spec, mesh)
    where = {}
    for dim, part in enumerate(spec):
        axes = part if isinstance(part, tuple) else (part,)
        if [a for a in names if a in axes] != [a for a in axes if a is not None]:
            raise ValueError(f"spec {spec} splits dimension {dim} over {axes}, not in the "
                             f"mesh's axis order {names}")
        for a in axes:
            if a is not None:
                where[a] = dim
    return tuple(Shard(where[a]) if a in where else Replicate() for a in names)


def local_range(length: int, mesh, pls, dim: int, ndim: int) -> tuple:
    """(start, size) of this rank's slice of dimension ``dim`` (of an
    ``ndim``-dimensional tensor whose dimension has ``length`` entries)
    under the placements ``pls``: ``torch.chunk``'s split, as DTensor's
    ``Shard`` cuts, nested over the mesh dimensions in order. Plain
    integers, so it runs under ``FakeTensorMode`` too."""
    from torch.distributed.tensor import Shard

    start, size = 0, length
    for i, p in enumerate(pls):
        if isinstance(p, Shard) and p.dim % ndim == dim % ndim:
            chunk = -(-size // mesh.size(i))
            lo = min(mesh.get_local_rank(i) * chunk, size)
            start, size = start + lo, min(lo + chunk, size) - lo
    return start, size


def set_param(model: torch.nn.Module, name: str, value: torch.Tensor) -> None:
    """Replace the parameter ``name`` (a ``named_parameters()`` name) of
    ``model`` by ``value`` (kept as the same object if it is a Parameter)."""
    *path, leaf = name.split(".")
    node = model
    for key in path:
        node = node[key] if isinstance(node, torch.nn.ModuleDict) else getattr(node, key)
    if not isinstance(value, torch.nn.Parameter):
        value = torch.nn.Parameter(value, requires_grad=value.requires_grad)
    node[leaf] = value


def distribute(model: torch.nn.Module, cfg, mesh, opt_state=None):
    """Replace every parameter of ``model`` by a DTensor on ``mesh`` placed
    by ``param_pspecs``. Every rank holds the same whole tensors before
    (a seeded build or a restored checkpoint), so each keeps its own shard
    and nothing is sent. Returns ``opt_state`` with its moments placed by
    ``opt_pspecs`` (AdamW's m and v, or SGD-momentum's m): the given whole
    tensors cut the same way, or, for ``opt_state`` None, None."""
    from torch.distributed.tensor import distribute_tensor

    pspecs = param_pspecs(model, cfg, mesh)
    ospecs = opt_pspecs(pspecs, model, mesh)
    names = [n for n, _ in model.named_parameters()]
    for name, p in list(model.named_parameters()):
        spec = pspecs[name.replace(".", "/")]
        placed = distribute_tensor(p.detach(), mesh, placements(spec, mesh), src_data_rank=None)
        set_param(model, name, placed.requires_grad_(p.requires_grad))
    if opt_state is None:
        return None

    def place(moments):
        if moments is None:
            return None
        return [distribute_tensor(t, mesh, placements(ospecs[n.replace(".", "/")], mesh),
                                  src_data_rank=None) for n, t in zip(names, moments)]

    return opt_state._replace(m=place(opt_state.m), v=place(opt_state.v))


def batch_slice(mesh, batch_size: int) -> slice:
    """This rank's rows of a global batch: the batch axis is split over
    ``batch_axes`` (major first) and replicated over the mesh's other
    axes."""
    axes = batch_axes(mesh, batch_size)
    shape = mesh_shape(mesh).shape
    idx, parts = 0, 1
    for a in axes:
        idx = idx * shape[a] + mesh.get_local_rank(a)
        parts *= shape[a]
    rows = batch_size // parts
    return slice(idx * rows, (idx + 1) * rows)
