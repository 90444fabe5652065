"""BIDENT core on PyTorch: profile → plan → execute.

Port of the main-path part of ``repro.core``: the NumPy planning layer
(ops, cost tables, workloads, the sequential solvers, schedules) copied
as it is, and the execution layer (targets, measured profiler, lane
programs, executor, orchestrator) rebuilt on torch tensors and devices.
"""
from .costmodel import (CPU, EDGE_PUS, GPU, NPU, CostEntry, CostTable,
                        DenseCostTable, EdgeSoCCostModel, PUSpec,
                        transition_cost)
from .errors import (ExecutionError, ExecutionTimeoutError,
                     FaultRetryExceededError, InfeasibleScheduleError,
                     PULostError)
from .executor import ScheduleExecutor
from .faults import (DEFAULT_POLICY, ExecutionPolicy, FaultPlan, FaultSpec,
                     TransientFault)
from .graph import build_dense_chain, build_sequential_graph
from .laneprogram import LaneProgram, compile_lane_program, results_bitwise_equal
from .modelgraph import (GRANITE_MAIN_PATH, arrays_to_device, chain_arrays,
                         kernel_chain)
from .op import FusedOp, OpGraph, chain_graph
from .orchestrator import Orchestrator, Plan
from .profiler import (AnalyticProfiler, MeasuredProfiler, Measurement,
                       measure_callable, measure_callable_stats)
from .schedule import (SeqSchedule, evaluate_sequential, schedule_from_dict,
                       schedule_to_dict, single_pu_cost)
from .search import (dijkstra, sequential_dp, sequential_dp_reference,
                     solve_sequential)
from .targets import (KERNEL_DIALECTS, Target, TargetRegistry, VARIANT_TOL,
                      resolve_targets, variant_tolerance)
from .workload import Workload
from . import backends  # noqa: F401
