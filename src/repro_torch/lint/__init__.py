"""``python -m repro_torch.lint`` — the schedule lint CLI.

Runs the static plan verifier and linter (``core.verify``) over every
registered strategy for an architecture's segment graphs, one row per
(strategy, phase, segment), and prints a diagnostic table; the exit
code is 1 when any plan carries an error-severity diagnostic::

    python -m repro_torch.lint transformer                # all strategies
    python -m repro_torch.lint moe --strategy dbo         # one strategy
    python -m repro_torch.lint mamba2-2.7b --phase decode --show-clean

Family aliases map to smoke configs (``transformer`` -> smollm-135m,
``moe`` -> deepseek-moe-16b, ``mamba2`` -> mamba2-2.7b); any registered
arch name works directly.  The default strategy set is every tunable
registry entry and ``sequential``, as in the JAX package's linter
(``dynamic`` and ``auto`` pick among the others; pass ``--strategy
dynamic`` to lint its per-context choice).
The port has no train step, so the phases are prefill and decode.  A
strategy that crashes while recording is reported as a diagnostic row
(code = the exception class), never a CLI crash.  Everything here runs
on the host: segment graphs are traced on the meta device.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..core.partition import partition
from ..core.scheduler import ScheduleContext, record_plan
from ..core.strategies import registry
from ..core.verify import Diagnostic, VerifyReport, lint_table, verify

#: family alias -> registered arch name (smoke configs keep this fast)
ARCH_ALIASES = {
    "transformer": "smollm-135m",
    "moe": "deepseek-moe-16b",
    "mamba2": "mamba2-2.7b",
}

PHASES = ("prefill", "decode")


def resolve_arch(name: str) -> str:
    return ARCH_ALIASES.get(name, name)


def _phase_shapes(phase: str, batch: int, seq: int):
    """(B, S, s_max) per phase — decode is single-token with a short KV
    horizon; the verifier only needs representative shapes."""
    if phase == "decode":
        return batch, 1, max(seq, 16)
    return batch, seq, seq


def lint_arch(arch: str, strategies: Optional[Sequence[str]] = None,
              phases: Sequence[str] = PHASES, batch: int = 4,
              seq: int = 16, lint: bool = True) -> list:
    """Verify every (strategy × phase × segment) plan for ``arch``.

    Returns ``[(label, VerifyReport), ...]`` with labels of the form
    ``"arch/strategy/phase/segment"``.  A recording failure becomes a
    one-diagnostic report (severity error, code = the exception class)
    so one broken strategy cannot hide the rest of the table."""
    from ..configs import get_smoke_config
    from ..models.layers import MeshInfo
    from ..models.registry import build_model

    arch = resolve_arch(arch)
    cfg = get_smoke_config(arch)
    model = build_model(cfg, MeshInfo(tp=1, dp=1))
    # default: every tunable scheduler (policy entries such as
    # ``dynamic`` and ``auto`` choose among them; ``spec_decode`` carries
    # a serve knob)
    names = list(strategies) if strategies else [
        n for n in registry.strategy_names()
        if registry.get_entry(n).tunable or n == "sequential"]
    rows = []
    for phase in phases:
        B, S, s_max = _phase_shapes(phase, batch, seq)
        segs, _ = model.build_segments(phase, B, S, s_max=s_max)
        info = ScheduleContext(local_batch=B, global_batch=B, seq_len=S,
                               phase=phase, arch=cfg.name)
        for name in names:
            for seg in segs:
                label = f"{arch}/{name}/{phase}/{seg.key}"
                try:
                    sched = registry.make_scheduler(name)
                    g = partition(seg.graph, sched.partition_rules())
                    plan = record_plan(g, sched, info)
                except Exception as e:                  # noqa: BLE001
                    rows.append((label, VerifyReport((Diagnostic(
                        "error", type(e).__name__, -1, (),
                        f"recording failed: {str(e)[:200]}",
                        "fix the strategy's schedule()"),))))
                    continue
                rows.append((label, verify(g, plan, lint=lint)))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Static plan verification & lint across registered "
                    "strategies (see repro_torch.core.verify.CODES)")
    p.add_argument("arch", help="arch name or family alias "
                   f"({', '.join(sorted(ARCH_ALIASES))})")
    p.add_argument("--strategy", action="append", default=None,
                   help="limit to this strategy (repeatable; default: "
                   "every registered scheduler)")
    p.add_argument("--phase", action="append", default=None,
                   choices=PHASES, help="limit to this phase (repeatable)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=16)
    p.add_argument("--no-lint", action="store_true",
                   help="errors only; skip warning-severity smells")
    p.add_argument("--show-clean", action="store_true",
                   help="also print rows with no diagnostics")
    p.add_argument("--codes", action="store_true",
                   help="print the diagnostic code table and exit")
    args = p.parse_args(argv)
    if args.codes:
        from ..core.verify import CODES
        for code, (sev, desc) in sorted(CODES.items()):
            print(f"{code}  {sev:<8} {desc}")
        return 0
    rows = lint_arch(args.arch, strategies=args.strategy,
                     phases=tuple(args.phase or PHASES),
                     batch=args.batch, seq=args.seq,
                     lint=not args.no_lint)
    print(lint_table(rows, include_clean=args.show_clean))
    n_err = sum(len(r.errors) for _, r in rows)
    n_warn = sum(len(r.warnings) for _, r in rows)
    print(f"\n{len(rows)} plan(s) checked: {n_err} error(s), "
          f"{n_warn} warning(s)")
    return 1 if n_err else 0
