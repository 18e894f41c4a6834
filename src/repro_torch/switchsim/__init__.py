"""The switch-dataplane emulator (port of ``repro.switchsim``).

Modules
-------
``dataplane``  — ``DataplaneConfig``; the slot state machine as torch
                 functions on an explicit device (``init_state``,
                 ``ingest_batch``, ``reclaim_dead_worker``) behind the
                 host-side handle ``BatchedDataplane``; the per-packet
                 numpy mirror ``NumpyDataplane``; the batch-per-round
                 all-reduce driver ``run_aggregation``. Multi-tenant: per-job
                 quotas, the weighted takeover lottery, priority preemption
                 and per-job counters.
``query``      — the in-switch query operators (Top-N compare, group-by
                 scatter-accumulate) that ``db/query.py`` streams rows
                 through.
``tenancy``    — several jobs on one dataplane: ``run_multitenant``, Jain
                 fairness, and the named shared-dataplane registry behind
                 the ``switch_emu`` strategy's ``switch_shared``.
``npfpisa``    — the numpy FPISA primitives of ``NumpyDataplane``.

``core/switch.py`` is the per-packet view: its ``FpisaSwitch`` drives a
one-pipeline ``BatchedDataplane`` one packet at a time.

Shared structural constants
---------------------------
``COUNTERS`` and ``SLOT_STATE_FIELDS`` are defined here, once, as in the
reference, and imported by the dataplanes: the counters in on-wire index
order (the counters plane is (num_jobs, len(COUNTERS)) in both), and the
per-slot state fields in ``DataplaneState`` order (the numpy dataplane
carries each as an underscore-prefixed attribute, ``exp`` -> ``self._exp``).
They must stay above the submodule imports below, which import them back.
"""
# per-job dataplane counters, in the reference's on-wire index order
COUNTERS = ("packets", "duplicates", "stale", "overwrite", "overflow",
            "reclaimed", "admission_denied", "preempted")

# per-slot/per-plane state fields, in the reference's DataplaneState order
SLOT_STATE_FIELDS = ("exp", "man", "seen", "slot_chunk", "result",
                     "result_valid", "counters", "recirc", "live",
                     "slot_job", "last_touch")

from repro_torch.switchsim.dataplane import (  # noqa: E402,F401
    BatchedDataplane,
    DataplaneConfig,
    DataplaneState,
    NumpyDataplane,
    ingest_batch,
    init_state,
    lottery_pref,
    reclaim_dead_worker,
    run_aggregation,
    slot_of,
    slot_of_tenant,
)
from repro_torch.switchsim.tenancy import (  # noqa: E402,F401
    jain_fairness,
    reset_shared_dataplanes,
    run_multitenant,
    shared_dataplane,
    shared_emulated_allreduce,
)
