"""SLO-aware request serving over continuous batching (counterpart of
``deepspeed_tpu/serving/``): admission control with explicit
backpressure, pluggable scheduler policies (FIFO / priority / EDF / fair
share) with anti-starvation aging, request lifecycle (cancel, stream,
deadline shedding), fault injection and preemption-safe recovery
(serving/faults.py, serving/recovery.py), the fleet of replicas behind
one router with failover by migration, drain and rolling restart
(serving/router.py, serving/fleet.py), the autoscaler
(serving/autoscaler.py), declarative scenarios (serving/scenarios.py),
and the load generator (``python -m deepspeed_tpu_torch.serving.loadgen``).
"""

from deepspeed_tpu_torch.serving.engine import ServingEngine, TokenStream
from deepspeed_tpu_torch.serving.fleet import (
    RID_STRIDE,
    Replica,
    ReplicaTelemetry,
    attach_replica_telemetry,
)
from deepspeed_tpu_torch.serving.router import FleetRouter, FleetStream
from deepspeed_tpu_torch.serving.autoscaler import AutoscalerConfig, FleetAutoscaler
from deepspeed_tpu_torch.serving.scenarios import (
    ChaosAction,
    Scenario,
    TenantMix,
    builtin_matrix,
    scenario_scorecard,
)
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
    "FleetRouter", "FleetStream", "Replica", "ReplicaTelemetry",
    "attach_replica_telemetry", "RID_STRIDE",
    "AutoscalerConfig", "FleetAutoscaler",
    "Scenario", "TenantMix", "ChaosAction", "builtin_matrix",
    "scenario_scorecard",
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
