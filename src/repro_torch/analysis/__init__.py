"""Static checks on LCMA schemes: exact Brent verification and stability."""
from .findings import ERROR, INFO, WARNING, Finding, format_findings, has_errors
from .brent import brent_residual, check_library, check_scheme, verify_or_raise
from .stability import (SchemeStability, analyze, check_library_stability,
                        check_quant_accumulator, check_scheme_stability,
                        dtype_eps, int8_accum_bound, max_safe_accum_depth)

__all__ = [
    "Finding", "ERROR", "WARNING", "INFO", "has_errors", "format_findings",
    "brent_residual", "check_scheme", "check_library", "verify_or_raise",
    "SchemeStability", "analyze", "check_scheme_stability",
    "check_library_stability", "dtype_eps", "int8_accum_bound",
    "max_safe_accum_depth", "check_quant_accumulator",
]
