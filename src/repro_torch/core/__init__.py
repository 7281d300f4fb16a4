"""Host controller (numpy/scipy), the device-side ``ScheduleTable``, the
device-resident controller with its batched auction LAP, and the paper's
cost models, baselines, simulator and synthetic traces (numpy/scipy)."""

from repro_torch.core.baselines import ideal_a2a_tokens, ring_a2a_tokens
from repro_torch.core.bvn import bvn_coefficients, bvn_decompose, bvn_decompose_batch
from repro_torch.core.cost_models import (
    WIRE_DTYPES,
    CommModel,
    ComputeModel,
    a2a_dispatch_tokens,
    fit_knee,
    knee_model,
    linear_model,
    phase_dispatch_tokens,
    pipeline_makespan,
    wire_bytes_per_token,
)
from repro_torch.core.decompose import STRATEGIES, decompose, decompose_batch
from repro_torch.core.device_controller import (
    DeviceController,
    DeviceControllerConfig,
    DeviceControllerState,
    apply_link_mask_traced,
    routing_to_traffic_traced,
)
from repro_torch.core.drift import DRIFT_KINDS, DriftScenario
from repro_torch.core.faults import (
    FAULT_KINDS,
    FabricFaultError,
    FaultScenario,
    NonFiniteLossError,
    apply_link_mask,
    check_schedule_mask,
    fault_hook,
)
from repro_torch.core.lap import auction_lap, auction_lap_batch, greedy_phases, matching_weight
from repro_torch.core.maxweight import WarmState, maxweight_decompose, maxweight_decompose_batch, warm_state_of
from repro_torch.core.runtime import (
    ControllerConfig,
    Decision,
    ScheduleRuntime,
    make_serving_controller,
    routing_to_traffic,
)
from repro_torch.core.schedule import (
    A2ASchedule,
    ScheduleTable,
    order_phases,
    phase_envelope,
    plan_schedule,
    ring_schedule,
)
from repro_torch.core.selector import DEFAULT_PLAN_KWARGS, Proposal, ScheduleEntry, ScheduleSelector
from repro_torch.core.simulator import SimResult, simulate_decomposition, simulate_ideal, simulate_sequential
from repro_torch.core.sinkhorn import is_doubly_stochastic, sinkhorn
from repro_torch.core.traffic import ROUTERS, WORKLOADS, gen_trace, traffic_matrix
from repro_torch.core.types import Decomposition, Phase, StackedPhases

__all__ = [
    "A2ASchedule",
    "CommModel",
    "ComputeModel",
    "ControllerConfig",
    "DEFAULT_PLAN_KWARGS",
    "DRIFT_KINDS",
    "Decision",
    "Decomposition",
    "DeviceController",
    "DeviceControllerConfig",
    "DeviceControllerState",
    "DriftScenario",
    "FAULT_KINDS",
    "FabricFaultError",
    "FaultScenario",
    "NonFiniteLossError",
    "Phase",
    "Proposal",
    "ROUTERS",
    "STRATEGIES",
    "ScheduleEntry",
    "ScheduleRuntime",
    "ScheduleSelector",
    "ScheduleTable",
    "SimResult",
    "StackedPhases",
    "WIRE_DTYPES",
    "WORKLOADS",
    "WarmState",
    "a2a_dispatch_tokens",
    "apply_link_mask",
    "apply_link_mask_traced",
    "auction_lap",
    "auction_lap_batch",
    "bvn_coefficients",
    "bvn_decompose",
    "bvn_decompose_batch",
    "check_schedule_mask",
    "decompose",
    "decompose_batch",
    "fault_hook",
    "fit_knee",
    "gen_trace",
    "greedy_phases",
    "ideal_a2a_tokens",
    "is_doubly_stochastic",
    "knee_model",
    "linear_model",
    "make_serving_controller",
    "matching_weight",
    "maxweight_decompose",
    "maxweight_decompose_batch",
    "order_phases",
    "phase_dispatch_tokens",
    "phase_envelope",
    "pipeline_makespan",
    "plan_schedule",
    "ring_a2a_tokens",
    "ring_schedule",
    "routing_to_traffic",
    "routing_to_traffic_traced",
    "simulate_decomposition",
    "simulate_ideal",
    "simulate_sequential",
    "sinkhorn",
    "traffic_matrix",
    "warm_state_of",
    "wire_bytes_per_token",
]
