"""falcon-check: static verification and lint for schemes, plans and caches.

Four passes, one currency (:class:`~repro_torch.analysis.findings.Finding`):

  * ``brent``: exact (integer, tolerance-free) verification of a scheme's
    Brent equations against the <m,k,n> matmul tensor;
  * ``stability``: Higham-style floating-point error-growth bounds and int8
    accumulator overflow bounds, computed from coefficients alone;
  * ``plan-lint`` / ``codegen-lint``: kernel plans checked against a
    hardware profile and the Hopper launch limits (shared memory, registers,
    threads, grid), and the Deployment Module's generated source re-derived
    at the AST level;
  * ``cache-audit``: persisted plan-cache invariants (dangling schemes,
    definition drift, key/payload consistency).

CLI: ``python -m repro_torch.tools.check``.
"""
from .findings import ERROR, INFO, WARNING, Finding, format_findings, has_errors
from .brent import brent_residual, check_library, check_scheme, verify_or_raise
from .stability import (SchemeStability, analyze, check_library_stability,
                        check_quant_accumulator, check_scheme_stability,
                        dtype_eps, int8_accum_bound, max_safe_accum_depth)
from .plans import (BACKEND_DTYPES, lint_block_plan, lint_codegen, lint_grouped_plan,
                    lint_quant_plans, lint_scheme_plans, lint_tiled_plan, lint_workload)
from .cache_audit import audit_cache_file, audit_entries

__all__ = [
    "Finding", "ERROR", "WARNING", "INFO", "has_errors", "format_findings",
    "brent_residual", "check_scheme", "check_library", "verify_or_raise",
    "SchemeStability", "analyze", "check_scheme_stability",
    "check_library_stability", "dtype_eps", "int8_accum_bound",
    "max_safe_accum_depth", "check_quant_accumulator",
    "lint_block_plan", "lint_scheme_plans", "lint_quant_plans", "lint_tiled_plan",
    "lint_grouped_plan", "lint_workload", "lint_codegen", "BACKEND_DTYPES",
    "audit_cache_file", "audit_entries",
]
