"""FlashMem core: overlap-plan generation + streaming execution.

Pipeline:  graph -> capacities -> LC-OPG solve -> OverlapPlan ->
           {simulate | StreamingExecutor}.
"""
from repro_torch.core.allocator import (AllocationResult, MixSpec, MixTracker,
                                        allocate_joint)
from repro_torch.core.capacity import HWSpec, THRESHOLDS, capacities
from repro_torch.core.fusion import adaptive_fusion_solve, fuse_graph
from repro_torch.core.graph import ModelGraph, build_lm_graph
from repro_torch.core.opg import OPGProblem, OPGSolution, check_constraints
from repro_torch.core.plan import (MultiModelPlan, OverlapPlan,
                                   plan_always_next, plan_multi_model,
                                   plan_preload_all, plan_same_op_type,
                                   simulate)
from repro_torch.core.solver import SolverConfig, solve, solve_validated
from repro_torch.core.streaming import (HostModel, PreloadExecutor,
                                        StreamingExecutor)

__all__ = [
    "AllocationResult", "MixSpec", "MixTracker", "allocate_joint",
    "HWSpec", "THRESHOLDS", "capacities", "adaptive_fusion_solve",
    "fuse_graph", "ModelGraph", "build_lm_graph",
    "OPGProblem", "OPGSolution", "check_constraints", "MultiModelPlan",
    "OverlapPlan", "plan_always_next", "plan_multi_model", "plan_preload_all",
    "plan_same_op_type", "simulate", "SolverConfig", "solve",
    "solve_validated", "HostModel", "PreloadExecutor", "StreamingExecutor",
]
