"""Deterministic fault injection for the serving stack (counterpart of
``deepspeed_tpu/serving/faults.py``): the serving domain of the port's
shared fault layer (:mod:`deepspeed_tpu_torch.faults`), re-exported under
its serving home. See that module's docstring for the taxonomy.
"""

from deepspeed_tpu_torch.faults import (
    FAULT_KINDS,
    HOOK_POINTS,
    EnginePreempted,
    Fault,
    FaultInjector,
    FaultPlan,
    FetchHang,
    InjectedFault,
    TickDispatchError,
)

__all__ = [
    "FAULT_KINDS",
    "HOOK_POINTS",
    "EnginePreempted",
    "Fault",
    "FaultInjector",
    "FaultPlan",
    "FetchHang",
    "InjectedFault",
    "TickDispatchError",
]
