"""PyTorch/CUDA port of the FPISA system (the JAX package ``repro`` is the
reference it is held against).

Same module layout as the reference: ``core/`` (bit-level FPISA numerics,
the aggregation facade and the bucketer), ``kernels/`` (hand-written Hopper
kernels with their plain PyTorch versions), ``switchsim/``, ``trace/``,
``autotune/``, ``runtime/``, ``models/``, ``optim/``, ``train/``,
``launch/``, ``configs/`` and ``data/``. The package imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``.

Entry points run on ``cuda`` unless the caller asks for the CPU; with no CUDA
device and no explicit CPU request they raise (:func:`resolve_device`).
"""
from __future__ import annotations

import torch


class NotPortedError(NotImplementedError):
    """A feature of the reference that the port does not have yet.

    The message names the feature; ``ROADMAP.md`` lists the slice that ports
    it."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not ported yet (see ROADMAP.md, "
                         f"'Modules to port')")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for ``cuda`` without a CUDA device
    raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the port on the CPU")
    return dev
