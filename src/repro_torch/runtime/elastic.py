"""Process-group layouts and elastic resume (torch port of
``repro.runtime.elastic``).

``make_groups(pods)`` is the counterpart of ``make_mesh_for(pods=...)``: it
lays the ranks of the default group out as a ``("pod", "data")``
``DeviceMesh`` (``launch/mesh.py``; global rank = ``pod * w_data + data``,
so each group rank is that axis's index) and returns the mesh's pod and
data groups.

``make_data_group(ranks)`` is the counterpart of ``make_mesh_for(devices,
data_only=True)``: a data group over the given ranks, which the elastic
controller regroups onto after a host death. ``resume_on_mesh`` restores the
newest checkpoint bundle onto this rank's device. Checkpoints hold whole
tensors, independent of the group, so a resume onto any group is exact.

``reproducible(device)`` makes the card's steps bit-reproducible
(deterministic algorithms), which a resume that must replay the same losses
needs.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import MeshShape, device_mesh
from repro_torch.runtime import checkpoint as ckpt


def make_groups(pods: int = 1):
    """(pod_group, data_group) of this rank over the default process group,
    laid out as ``pods`` x (world / pods). Every rank must call it, with the
    same ``pods`` (building a mesh's groups is collective over the default
    group). Pass the pair to ``Aggregator`` for hierarchical
    aggregation."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_groups needs an initialised default process group")
    world = dist.get_world_size()
    if pods <= 0 or world % pods:
        raise ValueError(f"cannot lay {world} ranks out as pods={pods} x data: "
                         f"{world} % {pods} != 0")
    mesh = device_mesh(MeshShape(("pod", "data"), (pods, world // pods)))
    return mesh["pod"].get_group(), mesh["data"].get_group()


def make_data_group(ranks):
    """A data group over ``ranks`` (ranks of the default group, in the
    order of their group ranks). Every rank of the default group must call
    it, with the same list, in the same order as every other group it
    creates. Without a process group the only rank is 0, and the group is
    None (a world of one). Returns the group; on a rank outside ``ranks``
    it is not a group this rank may use."""
    ranks = list(ranks)
    if not ranks or len(set(ranks)) != len(ranks):
        raise ValueError(f"a data group needs distinct ranks, got {ranks}")
    if not (dist.is_available() and dist.is_initialized()):
        if ranks != [0]:
            raise ValueError(f"without a process group the only rank is 0, got {ranks}")
        return None
    world = dist.get_world_size()
    if not all(0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} are not all in the default group of {world}")
    return dist.new_group(ranks)


def resume_on_mesh(ckpt_dir: str, like_params, like_opt, device):
    """Restore the newest checkpoint onto ``device``. Returns (params,
    opt_state, extra) as trees of tensors on ``device`` shaped like the
    ``like_*`` trees (``checkpoint.state_trees`` gives them), or None when
    there is no checkpoint.

    Expects the atomic bundle layout (``checkpoint.save_bundle`` with
    ``params`` / ``opt`` trees, the only layout that guarantees both landed
    on the same step); a single-tree step restores params only (opt None)."""
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        return None
    try:
        trees, extra = ckpt.restore_bundle(ckpt_dir, step, {"params": like_params,
                                                            "opt": like_opt})
        params, opt = trees["params"], trees["opt"]
    except ValueError:  # legacy single-tree checkpoint: params only
        params, extra = ckpt.restore(ckpt_dir, step, like_params)
        opt = None
    params, opt = (None if t is None else ckpt.map_tensors(lambda x: x.to(device), t)
                   for t in (params, opt))
    return params, opt, {"step": step, **extra}


@contextlib.contextmanager
def reproducible(device):
    """Bit-reproducible steps on the card inside the block: deterministic
    algorithms (``torch.use_deterministic_algorithms``; an op without a
    deterministic kernel raises) and the cuBLAS workspace setting they
    require (``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless already set). Both
    are restored on exit. cuBLAS and PyTorch read that variable once, when
    CUDA first sizes the cuBLAS workspace: set here, after that, it only
    passes PyTorch's check, so a process that wants the smaller workspace
    sets it before CUDA starts (the launcher does on the controller path).
    On the CPU, where the port's ops already repeat their bits, it changes
    nothing."""
    if torch.device(device).type != "cuda":
        yield
        return
    was = torch.are_deterministic_algorithms_enabled()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if env is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
