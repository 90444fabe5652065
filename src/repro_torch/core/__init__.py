"""BIDENT core on PyTorch: profile → plan → execute.

Port of ``repro.core``, with the autoshard cost provider on the H100's
constants (``repro_torch.core.autoshard``): the host layer (ops, cost tables, workloads,
contention laws, the sequential, parallel, DAG and concurrent solvers
with the warm and horizon re-planners, runtime conditions and the
dynamic scheduler, schedules, the paper's analytic zoo, per-target
health and circuit breakers, arrival and chaos traces, the serving
loop) copied as it is, and the execution layer (targets, measured
profiler, lane programs captured as CUDA graphs, executor, orchestrator
with online admission and PU-loss recovery) rebuilt on torch tensors,
devices and streams.
"""
from .contention import (ContentionModel, DEFAULT_MM_SF, GroupCostCache,
                         PairCostCache, uses_default_coexec,
                         uses_default_group)
from .costmodel import (CPU, DEFAULT_SF, EDGE_PUS, GPU, NPU, CostEntry,
                        CostTable, DenseCostTable, EdgeSoCCostModel, PUSpec,
                        transition_cost)
from .dynamic import DynamicScheduler, RuntimeCondition
from .errors import (ExecutionError, ExecutionTimeoutError,
                     FaultRetryExceededError, InfeasibleScheduleError,
                     PULostError)
from .executor import ScheduleExecutor
from .faults import (CHAOS_KINDS, DEFAULT_POLICY, ChaosEvent, ChaosTrace,
                     ExecutionPolicy, FaultPlan, FaultSpec, TransientFault)
from .health import (BreakerTransition, HealthMonitor, HealthPolicy,
                     TargetHealth)
from .graph import build_dense_chain, build_sequential_graph
from .laneprogram import (LanePool, LaneProgram, SegmentTime,
                          compile_lane_program, results_bitwise_equal)
from .modelgraph import (GRANITE_MAIN_PATH, arrays_to_device, chain_arrays,
                         kernel_chain)
from .op import Branch, FusedOp, OpGraph, Phase, chain_graph
from .orchestrator import Orchestrator, Plan
from .profiler import (AnalyticProfiler, MeasuredProfiler, Measurement,
                       measure_callable, measure_callable_stats,
                       trace_fused_ops)
from .schedule import (BranchSchedule, ConcurrentSchedule, ConcurrentStep,
                       DagSchedule, DagStep, ParallelSchedule, PhaseSchedule,
                       SeqSchedule, evaluate_sequential, schedule_from_dict,
                       schedule_to_dict, single_pu_cost)
from .search import (DAG_ALGORITHMS, DEFAULT_HORIZON_STATES,
                     DEFAULT_MAX_STATES, DEFAULT_WINDOW_STATES,
                     ConcurrentCaches,
                     IncrementalConcurrentSolver, dijkstra, sequential_dp,
                     sequential_dp_reference,
                     solve_concurrent, solve_concurrent_aligned,
                     solve_concurrent_aligned_reference,
                     solve_concurrent_horizon, solve_concurrent_joint,
                     solve_concurrent_joint_reference, solve_dag,
                     solve_parallel, solve_sequential)
from .serve import (SHED_REASONS, Arrival, ArrivalTrace, RequestRecord,
                    ServeReport, ServingEngine)
from .targets import (KERNEL_DIALECTS, Target, TargetRegistry, VARIANT_TOL,
                      resolve_targets, variant_tolerance)
from .workload import Workload
from . import autoshard, backends, paperzoo  # noqa: F401
