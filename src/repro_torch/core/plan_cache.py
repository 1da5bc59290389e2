"""Persistent, shape-keyed plan cache for the Decision Module.

``decide()`` enumerates every candidate LCMA and prices four pipeline stages
per candidate — cheap once, wasteful when a serving process re-traces the same
dozen linear-layer shapes millions of times (``launch/serve.py``,
``models/layers.py``). This module memoizes ``Decision`` objects behind a key
that captures everything the decision depends on:

  (M, K, N) local shape x dtype x hardware-profile fingerprint x dispatch
  policy (precombined-B / candidate set / min_speedup)

The cache is a bounded in-memory LRU, optionally backed by a JSON file so a
warmed cache survives process restarts (a tuning run writes
one next to the calibrated profile). The hardware fingerprint hashes the
profile's *numbers*, not just its name, so re-calibrating the machine
invalidates stale plans automatically.

Cached entries drop the per-candidate ``estimates`` breakdown on disk (it is
re-derivable); in-memory hits return the original ``Decision`` untouched.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import threading
import time

try:                      # POSIX advisory locks guard cross-process writes
    import fcntl
except ImportError:       # pragma: no cover - non-POSIX fallback
    fcntl = None

from . import algorithms
from . import decision as dec
from .hardware import HardwareProfile

log = logging.getLogger(__name__)

__all__ = ["CacheStats", "PlanCache", "plan_key", "default_cache", "configure",
           "stats", "flush", "reset", "DEFAULT_CAPACITY", "ENV_PATH"]

DEFAULT_CAPACITY = 4096
ENV_PATH = "FALCON_PLAN_CACHE"          # set => default cache persists here
_FORMAT_VERSION = 1


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0
    loaded: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return dict(hits=self.hits, misses=self.misses, inserts=self.inserts,
                    evictions=self.evictions, loaded=self.loaded,
                    hit_rate=round(self.hit_rate, 4))


def _profile_fingerprint(hw: HardwareProfile) -> str:
    """Short stable hash of the numbers a Decision depends on.

    Memoized on the (frozen, long-lived) profile object: plan_key runs on
    every trace-time plan() — the hot path this cache exists to shorten.
    """
    fp = getattr(hw, "_plan_fingerprint", None)
    if fp is None:
        blob = json.dumps([hw.name, hw.flops_mul, hw.flops_add, hw.beta,
                           hw.lcma_gemm_efficiency,
                           sorted((hw.dtype_flops or {}).items())])
        fp = hashlib.sha1(blob.encode()).hexdigest()[:12]
        object.__setattr__(hw, "_plan_fingerprint", fp)   # frozen dataclass
    return fp


def plan_key(M: int, K: int, N: int, hw: HardwareProfile, dtype: str, *,
             fused: bool = True, precombined_b: bool = False,
             mode: str = "auto", candidates: tuple[str, ...] | None = None,
             max_grid: int = 5, min_speedup: float = 1.0,
             batch: int = 1, shared_b: bool = False,
             accuracy_budget: float | None = None,
             quantize: bool = False) -> str:
    """Cache key for one Decision-Module invocation (local, per-device shape).

    ``batch > 1`` keys a *grouped* decision (``plan_batched``): the whole
    ``B x (M, K) @ (K, N)`` group lives under ONE ``gBxMxKxN`` key — never B
    per-element keys — and the shared-B (hoisted Combine-B) variant is keyed
    separately because it prices differently.

    ``accuracy_budget`` appends an ``ab=`` token only when a budget is set:
    a budget narrows the candidate set statically (stability-pass filter), so
    a budgeted plan must not alias the unbudgeted one.

    ``quantize`` appends a ``quant=1`` token only when the int8 tier was in
    the candidate search (the same conditional-token rule: fp-only keys keep
    their format), and ``fused=False`` (a backend whose H reaches memory,
    ``FalconConfig.fused``) a ``fused=0`` one.
    """
    cands = ",".join(candidates) if candidates is not None else f"grid<={max_grid}"
    shape = f"{M}x{K}x{N}" if batch == 1 else \
        f"g{batch}x{M}x{K}x{N}|sb={int(shared_b)}"
    parts = [
        f"{hw.name}@{_profile_fingerprint(hw)}", dtype, shape,
        f"mode={mode}", f"pre={int(precombined_b)}",
        f"ms={min_speedup:g}", cands,
    ]
    if accuracy_budget is not None:
        parts.append(f"ab={accuracy_budget:g}")
    if quantize:
        parts.append("quant=1")
    if not fused:
        parts.append("fused=0")
    return "|".join(parts)


@contextlib.contextmanager
def _file_lock(lock_path: str, timeout: float = 10.0):
    """Advisory inter-process lock around cache-file writes.

    ``flock`` is taken on a sidecar ``.lock`` file (never on the cache file
    itself — ``os.replace`` swaps that inode out from under any holder).
    flock contends between distinct fds, so it also serializes writer threads
    that each own their own :class:`PlanCache` on the same path. On timeout
    the writer proceeds unlocked with a warning — a stale or wedged lock
    holder must never take down the serving process; merge-on-save plus the
    atomic rename keeps even that race loss-bounded (one writer's fresh
    entries) rather than corrupting.
    """
    fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
    locked = False
    try:
        if fcntl is not None:
            deadline = time.monotonic() + timeout
            while True:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    locked = True
                    break
                except OSError:
                    if time.monotonic() >= deadline:
                        log.warning("plan cache lock %s: timeout after %.1fs; "
                                    "writing unlocked", lock_path, timeout)
                        break
                    time.sleep(0.01)
        yield
    finally:
        if locked:
            fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _encode(d: dec.Decision) -> dict:
    out = {
        "M": d.M, "N": d.N, "K": d.K, "dtype": d.dtype,
        "algo": d.algo.name if d.algo is not None else None,
        "gemm_seconds": d.gemm_seconds, "lcma_seconds": d.lcma_seconds,
    }
    if d.algo is not None:
        # Content hash of the scheme definition: load-time and falcon-check's
        # cache-audit pass both prove the cached decision still refers to the
        # coefficients it priced (a renamed/edited scheme drops the entry).
        out["algo_fp"] = d.algo.fingerprint
    if d.precision != "fp":
        out["prec"] = d.precision
    if isinstance(d, dec.GroupedDecision):
        out["B"] = d.B
        out["shared_b"] = d.shared_b
    return out


def _decode(payload: dict) -> dec.Decision | None:
    try:
        algo = payload.get("algo")
        l = algorithms.get(algo) if algo is not None else None
        fp = payload.get("algo_fp")
        if l is not None and fp is not None and fp != l.fingerprint:
            # The scheme registered under this name today is NOT the
            # definition the cached decision priced — stale entry, drop it.
            return None
        kw = dict(
            M=int(payload["M"]), N=int(payload["N"]), K=int(payload["K"]),
            dtype=str(payload["dtype"]), algo=l,
            gemm_seconds=float(payload["gemm_seconds"]),
            lcma_seconds=(None if payload["lcma_seconds"] is None
                          else float(payload["lcma_seconds"])),
            estimates=(),
            precision=str(payload.get("prec", "fp")),
        )
        if "B" in payload:   # grouped entry (plan_batched)
            return dec.GroupedDecision(B=int(payload["B"]),
                                       shared_b=bool(payload.get("shared_b")),
                                       **kw)
        return dec.Decision(**kw)
    except (KeyError, TypeError, ValueError):
        return None       # unknown scheme / malformed entry: drop, don't crash


class PlanCache:
    """Bounded LRU of ``Decision`` objects with optional JSON persistence."""

    def __init__(self, path: str | None = None,
                 capacity: int = DEFAULT_CAPACITY, autoload: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.path = path
        self.capacity = capacity
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict[str, dec.Decision] = \
            collections.OrderedDict()
        if path and autoload and os.path.exists(path):
            try:
                self.load(path)
            except (OSError, ValueError) as e:
                # A broken cache file must never take down the serving path;
                # start empty and let save() overwrite it.
                log.warning("plan cache %s unreadable (%s); starting empty",
                            path, e)

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: str) -> dec.Decision | None:
        with self._lock:
            d = self._entries.get(key)
            if d is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return d

    def insert(self, key: str, d: dec.Decision) -> None:
        with self._lock:
            if key not in self._entries and len(self._entries) >= self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
            self._entries[key] = d
            self._entries.move_to_end(key)
            self.stats.inserts += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def keys(self) -> list[str]:
        """Snapshot of cached plan keys (LRU order, oldest first).

        Introspection surface for the training warm pass and tests: a key
        embeds its local shape as ``{M}x{K}x{N}``, so callers can verify that
        e.g. both backward shapes of a layer were pre-planned."""
        with self._lock:
            return list(self._entries)

    def has_shape(self, M: int, K: int, N: int) -> bool:
        """True if any cached plan was keyed on local shape (M, K, N)."""
        token = f"|{M}x{K}x{N}|"
        with self._lock:
            return any(token in k for k in self._entries)

    # -- persistence --------------------------------------------------------

    def save(self, path: str | None = None, merge: bool = True) -> str:
        """Persist the cache: file lock -> merge on-disk entries -> atomic rename.

        Safe against concurrent writers (threads with their own caches, or
        separate serving processes sharing one warmed file): the sidecar lock
        serializes the read-merge-write, ``merge=True`` folds in entries some
        other writer landed since we loaded (our in-memory decisions win on
        key conflicts — they are newest), and the per-writer temp file +
        ``os.replace`` keeps readers from ever seeing a torn file.
        """
        path = path or self.path
        if path is None:
            raise ValueError("PlanCache.save: no path configured")
        apath = os.path.abspath(path)
        os.makedirs(os.path.dirname(apath), exist_ok=True)
        with _file_lock(apath + ".lock"):
            merged: list[tuple[str, dict]] = []
            if merge and os.path.exists(apath):
                try:
                    with open(apath) as f:
                        doc = json.load(f)
                    if doc.get("version") == _FORMAT_VERSION:
                        with self._lock:
                            merged = [(k, p) for k, p in doc.get("entries", [])
                                      if k not in self._entries]
                except (OSError, ValueError) as e:
                    log.warning("plan cache %s unreadable during save (%s); "
                                "overwriting", apath, e)
            with self._lock:
                entries = merged + [[k, _encode(d)]
                                    for k, d in self._entries.items()]
            doc = {"version": _FORMAT_VERSION, "entries": entries}
            # unique temp per writer: two unlocked writers must not share one
            tmp = f"{apath}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, apath)
        return path

    def load(self, path: str | None = None) -> int:
        """Merge entries from ``path``; returns the number of plans loaded."""
        path = path or self.path
        with open(path) as f:
            doc = json.load(f)
        if doc.get("version") != _FORMAT_VERSION:
            return 0
        n = 0
        with self._lock:
            for key, payload in doc.get("entries", []):
                d = _decode(payload)
                if d is None:
                    continue
                if key not in self._entries and len(self._entries) >= self.capacity:
                    self._entries.popitem(last=False)
                    self.stats.evictions += 1
                self._entries[key] = d
                n += 1
            self.stats.loaded += n
        return n


# ---------------------------------------------------------------------------
# Process-default cache (what falcon_gemm.plan() consults)
# ---------------------------------------------------------------------------

_default: PlanCache | None = None
_default_lock = threading.Lock()


def default_cache() -> PlanCache:
    global _default
    with _default_lock:
        if _default is None:
            _default = PlanCache(path=os.environ.get(ENV_PATH) or None)
        return _default


def configure(path: str | None = None,
              capacity: int = DEFAULT_CAPACITY, autoload: bool = True) -> PlanCache:
    """Replace the process-default cache (e.g. point it at a warmed file)."""
    global _default
    with _default_lock:
        _default = PlanCache(path=path, capacity=capacity, autoload=autoload)
        return _default


def stats() -> CacheStats:
    return default_cache().stats


def flush() -> str | None:
    """Persist the default cache if it has a backing path."""
    c = default_cache()
    return c.save() if c.path else None


def reset() -> None:
    """Drop the process-default cache entirely (tests)."""
    global _default
    with _default_lock:
        _default = None
