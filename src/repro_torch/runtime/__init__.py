"""Runtime policy for the port's launchers: fault injection, bounded retry,
straggler detection and the trainer's fault-tolerant runner
(``fault_tolerance``), the fleet's replicas (``replica``) and elastic
restarts from a checkpoint (``elastic``)."""
from repro_torch.runtime.elastic import (
    elastic_restore,
    replan_for_mesh,
    replan_params_for_mesh,
    respawn_device,
    respawn_mesh,
    serving_restore,
)
from repro_torch.runtime.fault_tolerance import (
    FAULT_COUNTER_KEYS,
    FaultInjector,
    FaultPolicy,
    FaultTolerantRunner,
    InjectedFault,
    LaunchFailedError,
    StragglerMonitor,
    export_fault_counters,
    parse_fault_plan,
    parse_fleet_plan,
)
from repro_torch.runtime.replica import Replica, health_score, spawn_replica

__all__ = [
    "FAULT_COUNTER_KEYS",
    "FaultInjector",
    "FaultPolicy",
    "FaultTolerantRunner",
    "InjectedFault",
    "LaunchFailedError",
    "Replica",
    "StragglerMonitor",
    "elastic_restore",
    "export_fault_counters",
    "health_score",
    "parse_fault_plan",
    "parse_fleet_plan",
    "replan_for_mesh",
    "replan_params_for_mesh",
    "respawn_device",
    "respawn_mesh",
    "serving_restore",
    "spawn_replica",
]
