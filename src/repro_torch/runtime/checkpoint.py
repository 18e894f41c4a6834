"""Fault-tolerant checkpointing: atomic commits, retention, async writes
(torch port of ``repro.runtime.checkpoint``, with its layout on disk).

Layout:
  <dir>/step_<n>.tmp/      while writing
  <dir>/step_<n>/          after atomic rename (commit point)
      manifest.json        {leaf path -> {file, shape, dtype}}, step, extra
      <i>.npy              one file per leaf
  <dir>/latest             text file holding the newest committed step

Bundle layout (``save_bundle``): params AND optimizer state (and any other
named trees) commit in ONE atomic rename, so they can never land on
different steps:
  <dir>/step_<n>/
      manifest.json        {"step": n, "extra": ..., "trees": ["opt","params"]}
      params/manifest.json + <i>.npy
      opt/manifest.json    + <i>.npy

``latest_step`` only reports steps whose manifest AND every listed tree's
manifest and leaf files exist: a partly written checkpoint (a crash
mid-save, a torn copy) is never visible to a restart.

Trees are nested dicts (walked in sorted key order), lists and tuples
(by index) and named tuples such as ``optim.optimizers.OptState`` (by field
name); leaf paths are the keys joined with ``/``, the reference's paths for
the same tree, so the two packages read each other's checkpoints
(``state_trees`` gives the model and optimizer state in the reference's
shape). Leaves are tensors or Python numbers; ``None`` holds no leaf.
bfloat16 has no numpy dtype without ``ml_dtypes``: its leaves are written
as their raw 16-bit words under the header numpy gives an ``ml_dtypes``
bfloat16 array (``'<V2'``), with ``"bfloat16"`` in the manifest, and read
back from such a file the same way. (The reference writes that file and
cannot cast it back: ``np.load`` gives ``V2`` words, which ``astype`` to
bfloat16 refuses.)
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.optim.optimizers import OptState

_BF16_DESCR = "<V2"  # numpy's header for an ml_dtypes bfloat16 array


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def _flatten(tree):
    """(paths, leaves, unflatten) in the reference's flatten order."""
    paths: list[str] = []
    leaves: list = []

    def walk(t, prefix):
        if t is None:
            return
        if isinstance(t, dict):
            for key in sorted(t):
                walk(t[key], prefix + (str(key),))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for field in t._fields:
                walk(getattr(t, field), prefix + (field,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, prefix + (str(i),))
        else:
            paths.append("/".join(prefix))
            leaves.append(t)

    walk(tree, ())

    def unflatten(values):
        it = iter(values)

        def build(t):
            if t is None:
                return None
            if isinstance(t, dict):
                built = {key: build(t[key]) for key in sorted(t)}
                return {key: built[key] for key in t}  # the tree's own key order
            if isinstance(t, tuple) and hasattr(t, "_fields"):
                return type(t)(*(build(getattr(t, f)) for f in t._fields))
            if isinstance(t, (list, tuple)):
                return type(t)(build(v) for v in t)
            return next(it)

        return build(tree)

    return paths, leaves, unflatten


def _nest(named) -> dict:
    """[("a.b.c", leaf), ...] -> {"a": {"b": {"c": leaf}}}."""
    tree: dict = {}
    for name, leaf in named:
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def state_trees(model: torch.nn.Module, opt_state: OptState) -> dict:
    """The model's parameters and the optimizer state as the reference's
    ``{"params", "opt"}`` trees: parameter paths from ``named_parameters()``
    (``embed/tok``, ...), the state as ``OptState(step, m, v)`` with m and v
    nested the same way. The leaves are the live tensors (no copy)."""
    names = [n for n, _ in model.named_parameters()]
    params = _nest((n, p.detach()) for n, p in model.named_parameters())

    def nest(ts):
        return None if ts is None else _nest(zip(names, ts))

    return {"params": params, "opt": OptState(step=opt_state.step, m=nest(opt_state.m),
                                              v=nest(opt_state.v))}


@torch.no_grad()
def load_state(model: torch.nn.Module, opt_state: OptState, trees: dict) -> OptState:
    """Copy restored ``{"params", "opt"}`` trees (the shape ``state_trees``
    gives) into the model's parameters and the optimizer state's tensors, in
    place; returns the state with the restored step. A tree given as None
    is left as it is."""
    live = state_trees(model, opt_state)
    for name in ("params", "opt"):
        if trees.get(name) is None:
            continue
        _, dst, _ = _flatten(live[name])
        _, src, _ = _flatten(trees[name])
        for d, s in zip(dst, src):
            if isinstance(d, torch.Tensor):
                d.copy_(s)
    step = opt_state.step if trees.get("opt") is None else int(trees["opt"].step)
    return OptState(step=step, m=opt_state.m, v=opt_state.v)


def map_tensors(fn, tree):
    """The tree with ``fn`` applied to every tensor leaf; other leaves as
    they are."""
    _, leaves, unflatten = _flatten(tree)
    return unflatten([fn(t) if isinstance(t, torch.Tensor) else t for t in leaves])


def host_copy(tree):
    """A CPU copy of every tensor leaf: a snapshot training cannot mutate."""
    return map_tensors(lambda t: t.detach().to("cpu", copy=True), tree)


# ---------------------------------------------------------------------------
# leaves on disk
# ---------------------------------------------------------------------------


def _save_leaf(path: str, leaf) -> dict:
    """Write one leaf as .npy; returns its manifest entry."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            words = t.view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": words.shape})
                f.write(words.tobytes())
            return {"shape": list(words.shape), "dtype": "bfloat16"}
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype == np.int64 and isinstance(leaf, int):
            arr = arr.astype(np.int32)  # the reference's integer scalars (step)
    np.save(path, arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}


def _load_leaf(path: str, dtype_name: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype_name == "bfloat16" or arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{path}: {arr.dtype} is not a 16-bit word array")
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _write_manifest(d: str, manifest: dict) -> None:
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def _write_tree(d: str, step: int, tree: Any, extra: dict | None = None) -> None:
    """Write one tree's leaves + manifest into ``d`` (no commit semantics)."""
    paths, leaves, _ = _flatten(tree)
    os.makedirs(d, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        fname = f"{i}.npy"
        manifest["leaves"][p] = {"file": fname, **_save_leaf(os.path.join(d, fname), leaf)}
    _write_manifest(d, manifest)


def _commit(ckpt_dir: str, step: int, tmp: str, keep: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # commit point
    with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(ckpt_dir, "latest.tmp"), os.path.join(ckpt_dir, "latest"))
    _retain(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None,
         keep: int = 3) -> str:
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    _write_tree(tmp, step, tree, extra)
    return _commit(ckpt_dir, step, tmp, keep)


def save_bundle(ckpt_dir: str, step: int, trees: dict[str, Any],
                extra: dict | None = None, keep: int = 3) -> str:
    """Atomically commit several named trees (e.g. params + opt) as ONE step.

    All trees are staged under ``step_<n>.tmp`` and become visible through a
    single rename: a crash at any point leaves either the complete step or
    nothing, never params without opt (module doc)."""
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    os.makedirs(tmp, exist_ok=True)
    names = sorted(trees)
    for name in names:
        _write_tree(os.path.join(tmp, name), step, trees[name])
    _write_manifest(tmp, {"step": step, "extra": extra or {}, "trees": names})
    return _commit(ckpt_dir, step, tmp, keep)


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(committed_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def committed_steps(ckpt_dir: str):
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            path = os.path.join(ckpt_dir, name, "manifest.json")
            if os.path.exists(path):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
    return out


def latest_step(ckpt_dir: str) -> int | None:
    """Newest *valid* checkpoint: the ``latest`` pointer if its target is
    valid, else a directory scan."""
    candidates = sorted(committed_steps(ckpt_dir), reverse=True)
    ptr = os.path.join(ckpt_dir, "latest")
    if os.path.exists(ptr):
        try:
            with open(ptr) as f:
                s = int(f.read().strip())
            if s in candidates and _valid(ckpt_dir, s):
                return s
        except (ValueError, OSError):
            pass
    for s in candidates:
        if _valid(ckpt_dir, s):
            return s
    return None


def _leaves_present(d: str, manifest: dict) -> bool:
    for meta in manifest.get("leaves", {}).values():
        if not os.path.exists(os.path.join(d, meta["file"])):
            return False
    return True


def _read_manifest(d: str) -> dict:
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def _valid(ckpt_dir: str, step: int) -> bool:
    """A step is valid only when its manifest AND, for bundles, every tree
    listed in it committed completely (all subtree manifests + leaf files)."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    try:
        manifest = _read_manifest(d)
    except (OSError, json.JSONDecodeError):
        return False
    if not _leaves_present(d, manifest):
        return False
    for name in manifest.get("trees", ()):
        sub = os.path.join(d, name)
        try:
            sub_manifest = _read_manifest(sub)
        except (OSError, json.JSONDecodeError):
            return False
        if not _leaves_present(sub, sub_manifest):
            return False
    return True


def _restore_dir(d: str, like: Any) -> tuple[Any, dict]:
    manifest = _read_manifest(d)
    paths, leaves, unflatten = _flatten(like)
    out = []
    for p, leaf in zip(paths, leaves):
        meta = manifest["leaves"][p]
        t = _load_leaf(os.path.join(d, meta["file"]), meta["dtype"])
        if isinstance(leaf, torch.Tensor):
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {p}: {tuple(t.shape)} vs "
                                 f"{tuple(leaf.shape)}")
            device = leaf.device if leaf.device.type != "meta" else torch.device("cpu")
            out.append(t.to(device=device, dtype=leaf.dtype))
        else:  # a Python number (the optimizer's step)
            if t.dim():
                raise ValueError(f"shape mismatch for {p}: {tuple(t.shape)} vs ()")
            out.append(type(leaf)(t.item()))
    return unflatten(out), manifest["extra"]


def restore(ckpt_dir: str, step: int, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (a tree of tensors, ``meta``
    tensors or numbers): each leaf takes ``like``'s dtype, and its device
    (the CPU for a meta tensor). Returns (tree, extra)."""
    return _restore_dir(os.path.join(ckpt_dir, f"step_{step}"), like)


def restore_bundle(ckpt_dir: str, step: int,
                   likes: dict[str, Any]) -> tuple[dict[str, Any], dict]:
    """Restore the named trees of a bundle step (``save_bundle`` layout).
    Trees whose ``like`` is None are skipped (returned as None)."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    manifest = _read_manifest(d)
    if "trees" not in manifest:
        raise ValueError(
            f"step {step} in {ckpt_dir} is not a bundle checkpoint "
            f"(manifest has no 'trees'); use restore() for single-tree steps")
    out = {}
    for name, like in likes.items():
        if like is None:
            out[name] = None
            continue
        if name not in manifest["trees"]:
            raise KeyError(f"bundle step {step} has no tree {name!r} "
                           f"(has {manifest['trees']})")
        out[name], _ = _restore_dir(os.path.join(d, name), like)
    return out, manifest["extra"]


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight at a time).
    The trees are copied to the host before ``save`` returns, so training
    may update its tensors in place right after."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None):
        self._launch(lambda t: save(self.ckpt_dir, step, t, extra, self.keep), tree)

    def save_bundle(self, step: int, trees: dict[str, Any], extra: dict | None = None):
        """Async atomic multi-tree commit (params + opt in one step)."""
        self._launch(lambda t: save_bundle(self.ckpt_dir, step, t, extra, self.keep), trees)

    def _launch(self, fn, tree):
        self.wait()
        host_tree = host_copy(tree)  # snapshot before training mutates

        def work():
            try:
                fn(host_tree)
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
