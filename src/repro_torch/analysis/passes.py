"""The pass registry: the analysis passes behind one discoverable surface.
Counterpart of `repro.analysis.passes`, with its pass names; the
reference's `vmem-budget` is `smem-budget` here, its counterpart on the
card (`analysis.smem`).

Each pass is a callable registered under a stable name with a one-line
summary: `available()` is what `scripts/torch_lint_movement.py --list`
prints, and adding a pass is one `@register_pass` away. The registry does
not normalise signatures: each pass takes what its problem needs (a
program and its arguments, a driver factory, a plan).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

from repro_torch.analysis.ledger import MovementLedger, check_model_coverage
from repro_torch.analysis.retrace import detect_retrace
from repro_torch.analysis.smem import SmemPlan
from repro_torch.analysis.tiling import lint_tiling

__all__ = ["AnalysisPass", "PASSES", "register_pass", "available",
           "get_pass"]


@dataclass(frozen=True)
class AnalysisPass:
    name: str
    summary: str
    run: Callable


PASSES: Dict[str, AnalysisPass] = {}


def register_pass(name: str, summary: str):
    """Register `fn` as the analysis pass `name`. Names are unique —
    re-registering is a bug, not an override."""
    def deco(fn):
        if name in PASSES:
            raise ValueError(f"analysis pass {name!r} already registered")
        PASSES[name] = AnalysisPass(name=name, summary=summary, run=fn)
        return fn
    return deco


def available() -> Tuple[Tuple[str, str], ...]:
    """(name, summary) of every registered pass, registration order."""
    return tuple((p.name, p.summary) for p in PASSES.values())


def get_pass(name: str) -> AnalysisPass:
    if name not in PASSES:
        known = ", ".join(PASSES)
        raise KeyError(f"no analysis pass {name!r}; registered: {known}")
    return PASSES[name]


# ---- the shipped passes ------------------------------------------------

@register_pass(
    "movement-ledger",
    "attribute every byte a recorded program's ops move to a category "
    "(wire / HBM / integrity / guard / collective / host)")
def movement_ledger_pass(fn, *args) -> MovementLedger:
    return MovementLedger.of(fn, *args)


@register_pass(
    "model-coverage",
    "fail when the ledger holds bytes no analytic model term claims "
    "(or a claim the count contradicts)")
def model_coverage_pass(fn, *args, claims, unpriced=("pallas_control",)):
    return check_model_coverage(MovementLedger.of(fn, *args), claims,
                                unpriced=unpriced)


@register_pass(
    "retrace",
    "flag config knobs whose static Python values change a block's op "
    "stream, and launch caches that grow with every block")
def retrace_pass(factory, perturbations, **kw):
    return detect_retrace(factory, perturbations, **kw)


@register_pass(
    "smem-budget",
    "statically sum named shared-memory and device buffers against "
    "SMEM_PER_BLOCK, SMEM_PER_SM and HBM_PER_CHIP and refuse over-budget "
    "configs before launch (the counterpart of vmem-budget)")
def smem_budget_pass(plan: SmemPlan) -> SmemPlan:
    return plan.check()


@register_pass(
    "tiling-contract",
    "lint every kernel op's operands and plans: 16-byte bases, TMA "
    "strides, dense operands, tile windows inside their operands, "
    "written windows inside what they alias")
def tiling_contract_pass(fn, *args, **kw):
    return lint_tiling(fn, *args, **kw)
