"""The switch-dataplane emulator, numpy parts (port of ``repro.switchsim``).

``dataplane`` holds ``DataplaneConfig``, the slot mapping, the single-tenant
per-packet ``NumpyDataplane`` and the batch-per-round all-reduce driver
``run_aggregation``; ``npfpisa`` its numpy FPISA primitives. The
``switch_emu`` aggregation strategy (``core/allreduce.py``) runs on them.

Not ported yet: multi-tenancy, the jitted ``BatchedDataplane``, the
per-packet ``core/switch.py`` shim, ``tenancy`` and ``query`` (ROADMAP.md).

Shared structural constants
---------------------------
``COUNTERS`` and ``SLOT_STATE_FIELDS`` are defined here, once, as in the
reference, and imported by the dataplane: the counters in on-wire index
order, and the per-slot state fields (the numpy dataplane carries each as an
underscore-prefixed attribute, ``exp`` -> ``self._exp``). They must stay
above the submodule import below, which imports them back.
"""
# dataplane counters, in the reference's on-wire index order (the last two
# count tenancy events and stay 0 on a single-tenant switch)
COUNTERS = ("packets", "duplicates", "stale", "overwrite", "overflow",
            "reclaimed", "admission_denied", "preempted")

# per-slot/per-plane state fields, in the reference's DataplaneState order,
# without its two tenancy fields (slot_job, last_touch)
SLOT_STATE_FIELDS = ("exp", "man", "seen", "slot_chunk", "result",
                     "result_valid", "counters", "recirc", "live")

from repro_torch.switchsim.dataplane import (  # noqa: E402,F401
    DataplaneConfig,
    NumpyDataplane,
    run_aggregation,
    slot_of,
)
