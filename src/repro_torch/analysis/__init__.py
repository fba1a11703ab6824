"""Static data-movement analysis of the port: audit a program's kernel ops
without running them (a fake trace) or as they run on the card.
Counterpart of `repro.analysis`.

Every hand kernel is a `repro_torch` op (`kernels.library`), so one
recorder of dispatched ops (`trace`, the counterpart of `jaxpr`) sees each
launch with its operands on either device. On it stand a byte-attribution
ledger and model-coverage gate (`ledger`), a retrace and launch-cache
detector (`retrace`), shared-memory plans checked at build time (`smem`,
the counterpart of `vmem`) and a tiling and alignment linter (`tiling`),
all registered in `passes` and driven over the port's programs by
`scripts/torch_lint_movement.py` on the CPU and by `chip_smoke.py`'s
phases 32-34 on the card.
"""
from repro_torch.analysis.ledger import (CATEGORIES, CoverageFailure,
                                         CoverageReport, ModelCoverageError,
                                         MovementLedger, MovementRecord,
                                         audit_movement,
                                         check_model_coverage,
                                         count_ppermute_bytes)
from repro_torch.analysis.passes import (PASSES, AnalysisPass, available,
                                         get_pass, register_pass)
from repro_torch.analysis.retrace import (Perturbation, RetraceFinding,
                                          RetraceReport, block_stream,
                                          detect_retrace, driver_fingerprint,
                                          launch_cache_sizes,
                                          make_static_parity_driver,
                                          make_traced_parity_driver)
from repro_torch.analysis.smem import (SmemBudgetExceeded, SmemBuffer,
                                       SmemPlan, attention_plan,
                                       distributed_block_plan,
                                       fused_ring_plan, plan_max_batch,
                                       rung_plan, scan_plan,
                                       serving_ring_plan)
from repro_torch.analysis.tiling import (LINE, VECTOR, TilingIssue,
                                         TilingReport, lint_records,
                                         lint_tiling)
from repro_torch.analysis.trace import (OpRecord, TensorMeta, fake_mode,
                                        fingerprint_parts, record_ops,
                                        structural_fingerprint, tensor_bytes)

__all__ = [
    "record_ops", "fake_mode", "tensor_bytes", "fingerprint_parts",
    "structural_fingerprint", "OpRecord", "TensorMeta",
    "CATEGORIES", "MovementRecord", "MovementLedger", "audit_movement",
    "count_ppermute_bytes",
    "CoverageFailure", "CoverageReport", "ModelCoverageError",
    "check_model_coverage",
    "Perturbation", "RetraceFinding", "RetraceReport", "detect_retrace",
    "driver_fingerprint", "block_stream", "launch_cache_sizes",
    "make_static_parity_driver", "make_traced_parity_driver",
    "SmemBudgetExceeded", "SmemBuffer", "SmemPlan", "fused_ring_plan",
    "distributed_block_plan", "serving_ring_plan", "plan_max_batch",
    "rung_plan", "attention_plan", "scan_plan",
    "TilingIssue", "TilingReport", "lint_tiling", "lint_records", "LINE",
    "VECTOR",
    "AnalysisPass", "PASSES", "register_pass", "available", "get_pass",
]
