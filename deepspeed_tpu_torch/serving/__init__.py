"""SLO-aware request serving over continuous batching (counterpart of
``deepspeed_tpu/serving/``), single replica: admission control with
explicit backpressure, pluggable scheduler policies (FIFO / priority / EDF
/ fair share) with anti-starvation aging, request lifecycle (cancel,
stream, deadline shedding), fault injection and preemption-safe recovery
(serving/faults.py, serving/recovery.py), and the load generator
(``python -m deepspeed_tpu_torch.serving.loadgen``).

Not ported yet (ROADMAP.md Queue 1 item 11 (a), second part): the fleet
(``router``, ``fleet``, ``autoscaler``, ``scenarios``)."""

from deepspeed_tpu_torch.serving.engine import ServingEngine, TokenStream
from deepspeed_tpu_torch.serving.faults import (
    EnginePreempted,
    Fault,
    FaultInjector,
    FaultPlan,
    FetchHang,
    InjectedFault,
    TickDispatchError,
)
from deepspeed_tpu_torch.serving.policies import (
    EdfPolicy,
    FairSharePolicy,
    FifoPolicy,
    PriorityPolicy,
    SchedulerPolicy,
    resolve_policy,
)
from deepspeed_tpu_torch.serving.recovery import (
    RecoveryConfig,
    RecoveryFailed,
    RecoveryLog,
)
from deepspeed_tpu_torch.serving.request import (
    ADMITTED,
    CANCELLED,
    EXPIRED,
    FINISHED,
    QUEUED,
    QUEUED_STATUS,
    RUNNING,
    SHED,
    TERMINAL_STATES,
    Admission,
    ServeRequest,
)

__all__ = [
    "ServingEngine", "TokenStream",
    "SchedulerPolicy", "FifoPolicy", "PriorityPolicy", "EdfPolicy",
    "FairSharePolicy", "resolve_policy",
    "Admission", "ServeRequest",
    "Fault", "FaultPlan", "FaultInjector",
    "InjectedFault", "TickDispatchError", "FetchHang", "EnginePreempted",
    "RecoveryConfig", "RecoveryFailed", "RecoveryLog",
    "ADMITTED", "QUEUED_STATUS", "SHED",
    "QUEUED", "RUNNING", "FINISHED", "CANCELLED", "EXPIRED",
    "TERMINAL_STATES",
]
