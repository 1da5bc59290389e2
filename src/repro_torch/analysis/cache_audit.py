"""Pass 4: the plan-cache invariant audit.

A persisted plan cache (``core/plan_cache.py``) is a promise: "this Decision
was computed for exactly this (shape, dtype, hardware, policy) key and these
scheme definitions". The serving loader (`PlanCache.load` / `_decode`) is
deliberately permissive — a broken entry is *dropped*, never fatal — which is
right for production but wrong for CI: silently dropped plans are cold-start
regressions waiting to happen. This auditor reads the raw file (NOT through
`_decode`) and reports every invariant violation:

  * format/version and entry structure;
  * decisions naming schemes absent from the current library (dangling refs);
  * scheme-definition drift: entries carry the scheme's content fingerprint
    (``LCMA.fingerprint``, hashed over the coefficient tensors) and an entry
    whose fingerprint no longer matches the registered definition is stale —
    the plan priced a different algorithm than the one that would now run;
  * key/payload consistency: the shape token embedded in the key must match
    the decision's recorded shape, grouped keys must match ``B``/``shared_b``,
    sharded keys must name a known layout and the same device count, and an
    int8 decision (``prec``) must sit under a key whose search had the
    quantized tier in it (``quant=1``);
  * hardware-fingerprint staleness against a given profile;
  * duplicate keys and non-finite / negative timings.
"""
from __future__ import annotations

import json
import math
import re

from repro_torch.core.hardware import HardwareProfile

from .findings import ERROR, INFO, WARNING, Finding

__all__ = ["audit_cache_file", "audit_entries"]

PASS = "cache-audit"

_FORMAT_VERSION = 1
_HW_TOKEN = re.compile(r"^[^|@]+@[0-9a-f]{12}$")


def _shape_token(payload: dict) -> str:
    """Reconstruct the key's shape token from a decoded payload.

    ``plan_key`` is called as (M, K, N) and formats ``{M}x{K}x{N}``; the
    payload stores the Decision fields (M, N, K).
    """
    M, N, K = payload["M"], payload["N"], payload["K"]
    if "B" in payload:
        return f"g{payload['B']}x{M}x{K}x{N}|sb={int(bool(payload.get('shared_b')))}"
    return f"{M}x{K}x{N}"


def audit_entries(entries, *, hw: HardwareProfile | None = None,
                  subject: str = "plan-cache") -> list[Finding]:
    """Audit decoded ``[key, payload]`` pairs; see module docstring."""
    from repro_torch.core import algorithms, decision as dec, plan_cache

    findings: list[Finding] = []
    lib = algorithms.library()
    seen: set[str] = set()
    for idx, item in enumerate(entries):
        if not (isinstance(item, (list, tuple)) and len(item) == 2
                and isinstance(item[0], str) and isinstance(item[1], dict)):
            findings.append(Finding(PASS, ERROR, subject,
                                    f"entry #{idx} is not a [key, payload] pair"))
            continue
        key, payload = item
        ksub = f"{subject}[{key}]"
        if key in seen:
            findings.append(Finding(PASS, ERROR, ksub, "duplicate cache key"))
        seen.add(key)

        # structural payload checks
        try:
            M, N, K = (int(payload[f]) for f in ("M", "N", "K"))
        except (KeyError, TypeError, ValueError):
            findings.append(Finding(PASS, ERROR, ksub,
                                    "payload lacks integer M/N/K fields"))
            continue
        if min(M, N, K) < 1:
            findings.append(Finding(PASS, ERROR, ksub,
                                    f"non-positive shape ({M}, {N}, {K})"))
        for f in ("gemm_seconds", "lcma_seconds", "coll_seconds"):
            v = payload.get(f)
            if v is not None and (not isinstance(v, (int, float))
                                  or not math.isfinite(v) or v < 0):
                findings.append(Finding(
                    PASS, ERROR, ksub, f"{f} = {v!r} is not a finite "
                    f"non-negative number"))

        # hardware token: first |-separated part is name@fingerprint
        parts = key.split("|")
        if not _HW_TOKEN.match(parts[0]):
            findings.append(Finding(
                PASS, ERROR, ksub,
                f"key does not start with a hardware token "
                f"(name@fingerprint12): {parts[0]!r}"))
        elif hw is not None:
            name, fp = parts[0].rsplit("@", 1)
            if name == hw.name and fp != plan_cache._profile_fingerprint(hw):
                findings.append(Finding(
                    PASS, WARNING, ksub,
                    f"hardware fingerprint {fp} is stale for profile "
                    f"{hw.name!r} (current "
                    f"{plan_cache._profile_fingerprint(hw)}); the machine "
                    f"was re-calibrated since this plan was priced"))

        # key shape token vs payload shape
        # (a grouped token spans two |-parts: gBxMxKxN|sb=S)
        token = _shape_token(payload)
        if f"|{token}|" not in f"|{key}|":
            findings.append(Finding(
                PASS, ERROR, ksub,
                f"key shape token does not match payload: expected "
                f"{token!r} for (M={M}, N={N}, K={K})"))

        # a quantized decision comes only from a search with the int8 tier
        prec = payload.get("prec", "fp")
        if prec != "fp" and "quant=1" not in parts:
            findings.append(Finding(
                PASS, ERROR, ksub,
                f"decision precision {prec!r} under a key without the quant=1 "
                f"token (the int8 tier was not in that search)"))

        # scheme reference + definition drift
        algo = payload.get("algo")
        if algo is not None:
            l = lib.get(algo)
            if l is None:
                findings.append(Finding(
                    PASS, ERROR, ksub,
                    f"decision names scheme {algo!r} which is not in the "
                    f"current library (dangling reference; entry would be "
                    f"silently dropped at load)"))
            else:
                fp = payload.get("algo_fp")
                if fp is None:
                    findings.append(Finding(
                        PASS, INFO, ksub,
                        f"entry predates scheme fingerprinting; cannot prove "
                        f"{algo!r} is unchanged"))
                elif fp != l.fingerprint:
                    findings.append(Finding(
                        PASS, ERROR, ksub,
                        f"scheme {algo!r} definition changed since this plan "
                        f"was priced (entry fingerprint {fp}, current "
                        f"{l.fingerprint}); the plan is stale"))

        # sharded entries: known layout, device count consistent with key
        ly = payload.get("ly")
        if ly is not None:
            try:
                dec.layout_by_name(str(ly))
            except KeyError:
                findings.append(Finding(
                    PASS, ERROR, ksub,
                    f"decision records unknown shard layout {ly!r}"))
            m = re.search(r"\|ly=.*xD(\d+)@cb=", key)
            if m is None:
                findings.append(Finding(
                    PASS, ERROR, ksub,
                    "sharded decision but key has no ly=...xD<devices>@cb= "
                    "layout token"))
            elif int(m.group(1)) != int(payload.get("D", -1)):
                findings.append(Finding(
                    PASS, ERROR, ksub,
                    f"key was priced for D={m.group(1)} devices but the "
                    f"decision records D={payload.get('D')}"))
    return findings


def audit_cache_file(path: str, *, hw: HardwareProfile | None = None) -> list[Finding]:
    """Audit one persisted plan-cache JSON file."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        return [Finding(PASS, ERROR, path, f"unreadable: {e}")]
    except ValueError as e:
        return [Finding(PASS, ERROR, path, f"not valid JSON: {e}")]
    if not isinstance(doc, dict) or doc.get("version") != _FORMAT_VERSION:
        return [Finding(PASS, ERROR, path,
                        f"unknown cache format version "
                        f"{doc.get('version') if isinstance(doc, dict) else doc!r} "
                        f"(expected {_FORMAT_VERSION})")]
    entries = doc.get("entries", [])
    findings = audit_entries(entries, hw=hw, subject=path)
    findings.append(Finding(PASS, INFO, path,
                            f"audited {len(entries)} cache entries"))
    return findings
