"""Finding: the common currency of every ``falcon-check`` pass.

A static-analysis pass never raises on a defect in the *artifact* it audits
(a scheme, a block plan, a cache file) — it returns :class:`Finding` objects
so one run can report every problem at once, the CLI can exit non-zero on
errors while letting warnings through, and tests can assert on exactly which
pass flagged what.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Finding", "ERROR", "WARNING", "INFO", "has_errors", "format_findings"]

ERROR = "error"        # artifact is wrong: must not be promoted / executed
WARNING = "warning"    # suspicious but executable (e.g. high error growth)
INFO = "info"          # measurement surfaced for the record (bounds, stats)

_SEVERITIES = (ERROR, WARNING, INFO)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect or observation from a static-analysis pass.

    ``pass_name`` is the stable identifier tests and CI grep for:
    ``brent`` | ``stability`` | ``plan-lint`` | ``codegen-lint`` |
    ``cache-audit``.
    """

    pass_name: str
    severity: str
    subject: str          # scheme name / plan id / cache key
    message: str

    def __post_init__(self):
        if self.severity not in _SEVERITIES:
            raise ValueError(f"Finding severity {self.severity!r} not in "
                             f"{_SEVERITIES}")

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def __str__(self) -> str:
        return f"[{self.pass_name}] {self.severity}: {self.subject}: {self.message}"


def has_errors(findings) -> bool:
    return any(f.is_error for f in findings)


def format_findings(findings, *, show_info: bool = False) -> str:
    """Human-readable report, grouped by pass, errors first within a pass."""
    shown = [f for f in findings if show_info or f.severity != INFO]
    if not shown:
        hidden = len(list(findings)) - len(shown)
        if hidden:
            return (f"no errors or warnings "
                    f"({hidden} info finding(s) hidden; use --show-info)")
        return "no findings"
    order = {ERROR: 0, WARNING: 1, INFO: 2}
    by_pass: dict[str, list[Finding]] = {}
    for f in shown:
        by_pass.setdefault(f.pass_name, []).append(f)
    lines = []
    for name in sorted(by_pass):
        group = sorted(by_pass[name], key=lambda f: order[f.severity])
        n_err = sum(f.is_error for f in group)
        lines.append(f"{name}: {len(group)} finding(s), {n_err} error(s)")
        for f in group:
            lines.append(f"  {f.severity:7s} {f.subject}: {f.message}")
    return "\n".join(lines)
