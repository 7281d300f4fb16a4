"""Host planner (numpy/scipy) and the device-side ``ScheduleTable``."""

from repro_torch.core.decompose import STRATEGIES, decompose
from repro_torch.core.maxweight import maxweight_decompose
from repro_torch.core.runtime import DEFAULT_PLAN_KWARGS, plan_serving_table, routing_to_traffic
from repro_torch.core.schedule import A2ASchedule, ScheduleTable, phase_envelope, plan_schedule
from repro_torch.core.types import Decomposition, Phase, StackedPhases

__all__ = [
    "A2ASchedule",
    "DEFAULT_PLAN_KWARGS",
    "Decomposition",
    "Phase",
    "STRATEGIES",
    "ScheduleTable",
    "StackedPhases",
    "decompose",
    "maxweight_decompose",
    "phase_envelope",
    "plan_schedule",
    "plan_serving_table",
    "routing_to_traffic",
]
