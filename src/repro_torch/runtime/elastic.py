"""Process-group layouts (torch port of the layout half of
``repro.runtime.elastic``; the re-mesh and resume half comes with the
elastic runtime, ROADMAP.md).

``make_groups(pods)`` is the counterpart of ``make_mesh_for(pods=...)``: the
reference lays the devices out as a ``("pod", "data")`` mesh; the port
builds, over the ranks of the default group, one data group per pod and one
pod group per data index, with the mesh's layout: global rank =
``pod * w_data + data``, so each group rank is that axis's index.
"""
from __future__ import annotations

import torch.distributed as dist


def make_groups(pods: int = 1):
    """(pod_group, data_group) of this rank over the default process group,
    laid out as ``pods`` x (world / pods). Every rank must call it, with the
    same ``pods`` (``torch.distributed.new_group`` is collective over the
    default group). Pass the pair to ``Aggregator`` for hierarchical
    aggregation."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_groups needs an initialised default process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if pods <= 0 or world % pods:
        raise ValueError(f"cannot lay {world} ranks out as pods={pods} x data: "
                         f"{world} % {pods} != 0")
    w_data = world // pods
    pod_group = data_group = None
    # every rank creates every group, in the same order
    for p in range(pods):
        g = dist.new_group([p * w_data + d for d in range(w_data)])
        if rank // w_data == p:
            data_group = g
    for d in range(w_data):
        g = dist.new_group([p * w_data + d for p in range(pods)])
        if rank % w_data == d:
            pod_group = g
    return pod_group, data_group
