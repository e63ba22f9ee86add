"""DynaFlow core on PyTorch — transparent & flexible intra-device
parallelism via programmable operator scheduling.

Public API:
  Module / Op / Param / FnOp / trace / mark       — frontend capture
  SplitModule / SplitFunc / Mark / partition      — graph partition (Fig. 5)
  OpSchedulerBase / SchedCtx / record_plan        — programmable scheduling (Fig. 6)
  StrategyPolicy / by_phase / by_token_threshold
  / first_viable / when                           — per-context strategy policies
  static_analysis / Realizer / realize            — backend (Alg. 1)
  lower / specialize / LoweredPlan / LoweringError
                                                  — the slot IR
  PlanStore / fingerprint_v2 / FINGERPRINT_VERSION
                                                  — plan/graph cache
  verify / verify_plan / verify_lowered / lint_plan / enforce
  / VerifyReport / PlanVerificationError / Diagnostic
                                                  — plan verifier and linter
  sequential_plan                                 — reference fallback
"""
from .analysis import AnalysisResult, static_analysis
from .backend import FusedCallInfo, Realizer, realize, sequential_plan
from .graph import FULL, OpGraph, OpNode, TensorRef
from .lowering import LoweredPlan, LoweringError, lower, specialize
from .module import FnOp, Module, Op, Param, TensorSpec, mark, trace
from .partition import Mark, SplitEveryOp, SplitFunc, SplitModule, partition
from .plan import (FINGERPRINT_VERSION, ExecutionPlan, OpHandle, PlanStep,
                   graph_fingerprint, scheduler_identity, strategy_salt,
                   structural_fingerprint, structural_key)
from .plan_store import PlanStore, fingerprint_v2
from .policy import (StrategyPolicy, as_policy, by_phase,
                     by_token_threshold, first_viable, has_ops,
                     local_batch_below, phase_is, resolve_strategy,
                     tokens_of, when)
from .scheduler import (OpSchedulerBase, SchedCtx, ScheduleContext,
                        ScheduleError, record_plan)
from .verify import (Diagnostic, PlanVerificationError, VerifyReport,
                     enforce, lint_plan, verify, verify_lowered, verify_plan)

__all__ = [
    "FULL", "OpGraph", "OpNode", "TensorRef",
    "FnOp", "Module", "Op", "Param", "TensorSpec", "mark", "trace",
    "Mark", "SplitEveryOp", "SplitFunc", "SplitModule", "partition",
    "ExecutionPlan", "OpHandle", "PlanStep", "graph_fingerprint",
    "OpSchedulerBase", "SchedCtx", "ScheduleContext", "ScheduleError",
    "record_plan",
    "StrategyPolicy", "as_policy", "by_phase", "by_token_threshold",
    "first_viable", "when", "has_ops", "local_batch_below", "phase_is",
    "resolve_strategy", "tokens_of",
    "scheduler_identity", "structural_key", "structural_fingerprint",
    "strategy_salt", "FINGERPRINT_VERSION", "PlanStore", "fingerprint_v2",
    "Diagnostic", "PlanVerificationError", "VerifyReport", "enforce",
    "lint_plan", "verify", "verify_lowered", "verify_plan",
    "AnalysisResult", "static_analysis",
    "FusedCallInfo", "Realizer", "realize", "sequential_plan",
    "LoweredPlan", "LoweringError", "lower", "specialize",
]
