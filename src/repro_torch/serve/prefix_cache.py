"""Radix prefix cache: shared prompt prefixes skip re-prefill.

Serving traffic repeats prompt prefixes constantly — system prompts, few-shot
preambles, multi-turn histories. The engine snapshots each finished prefill's
slot KV (and recurrent state) keyed by the prompt tokens; a later request
whose prompt extends a cached prefix copies the snapshot into its slot and
prefills only the suffix. The index is a compressed radix trie over token
sequences, so ``lookup`` returns the *longest* cached prefix in one walk and
shared prefixes share trie nodes.

Entries are evicted LRU under a fixed capacity, except entries **pinned** by
an in-flight request (looked up at submit, released once the snapshot is
copied into the slot): a pinned entry is never evicted, so the payload a
scheduled request depends on cannot vanish between admission and prefill
(property-tested in ``tests/test_torch_serve_spec.py``).

Payloads are opaque to the cache. The engine stores attention K/V rows
sliced to the prefix length, the recurrent SSM/hybrid state whole, and the
draft model's KV when speculation is on. It looks up ``prompt[:-1]``, so at
least one suffix token always prefills and the last-token logits are always
recomputed. K/V slices to any length, so a K/V-only snapshot is keyed at
``prompt[:-1]`` and an identical resubmission hits it; a state snapshot is
valid only at exactly its length, so a state-bearing one is keyed at the
full prompt and serves the prompts that extend it (:func:`snapshot_len`).
"""
from __future__ import annotations

import itertools
import threading
from typing import Any

__all__ = ["PrefixEntry", "RadixPrefixCache", "check_kv_cache", "snapshot_len",
           "snapshot_rows"]

# Cache entries a prefix snapshot takes: attention K/V (L, B, S, Hkv, hd),
# sliced to the prefix length, and the recurrent SSD state (L, B, H, N, P),
# which has no sequence axis and is taken whole.
KV_ENTRIES = ("k", "v")
STATE_ENTRY = "state"


def check_kv_cache(cache: dict) -> dict:
    """``cache`` itself, if a prefix snapshot knows every entry of it
    (attention K/V and the recurrent ``state``); a ValueError otherwise."""
    unknown = sorted(set(cache) - {*KV_ENTRIES, STATE_ENTRY})
    if unknown:
        raise ValueError(f"prefix snapshots take {KV_ENTRIES} and {STATE_ENTRY!r}; "
                         f"the cache also holds {unknown}")
    return cache


def snapshot_len(cache: dict, prompt_len: int) -> int:
    """The key length of a finished prefill's snapshot: the whole prompt
    when the cache holds recurrent state (valid only at its exact length),
    else ``prompt_len - 1``, the longest key a lookup of ``prompt[:-1]`` can
    match."""
    return prompt_len if STATE_ENTRY in cache else prompt_len - 1


def snapshot_rows(name: str, entry, slot: int, n: int):
    """The view of cache ``entry`` (named ``name``) that a snapshot of
    ``slot``'s first ``n`` positions takes: K/V sliced to ``n`` positions,
    the state whole."""
    return entry[:, slot] if name == STATE_ENTRY else entry[:, slot, :n]


class PrefixEntry:
    """One cached prefix: its token key, an opaque payload, and a pin count."""

    __slots__ = ("tokens", "payload", "pins", "tick")

    def __init__(self, tokens: tuple[int, ...], payload: Any):
        self.tokens = tokens
        self.payload = payload
        self.pins = 0
        self.tick = 0

    def __len__(self) -> int:
        return len(self.tokens)

    def __repr__(self) -> str:
        return (f"PrefixEntry(len={len(self.tokens)}, pins={self.pins}, "
                f"tick={self.tick})")


class _Node:
    """Radix trie node; the incoming edge holds a run of tokens."""

    __slots__ = ("edge", "children", "entry")

    def __init__(self, edge: tuple[int, ...] = ()):
        self.edge = edge
        self.children: dict[int, _Node] = {}
        self.entry: PrefixEntry | None = None


class RadixPrefixCache:
    """Compressed-trie prefix cache with LRU eviction and pinning.

    Thread-safe: ``lookup`` runs on submit (frontend threads), ``insert`` /
    ``release`` on the engine's step thread.
    """

    def __init__(self, max_entries: int = 32):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self._root = _Node()
        self._entries: dict[tuple[int, ...], PrefixEntry] = {}
        self._clock = itertools.count(1)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- queries -------------------------------------------------------------

    def lookup(self, tokens, pin: bool = False
               ) -> tuple[int, PrefixEntry | None]:
        """Longest cached prefix of ``tokens`` -> (length, entry).

        ``pin=True`` bumps the entry's pin count — the caller owns a
        reference that blocks eviction until :meth:`release`. Returns
        ``(0, None)`` on a miss.
        """
        toks = tuple(int(t) for t in tokens)
        with self._lock:
            best: PrefixEntry | None = None
            node, i = self._root, 0
            while i < len(toks):
                child = node.children.get(toks[i])
                if child is None:
                    break
                edge = child.edge
                if toks[i:i + len(edge)] != edge:
                    break           # partial edge match: no entry down here
                i += len(edge)
                node = child
                if node.entry is not None:
                    best = node.entry
            if best is None:
                self.misses += 1
                return 0, None
            self.hits += 1
            best.tick = next(self._clock)
            if pin:
                best.pins += 1
            return len(best.tokens), best

    def release(self, entry: PrefixEntry) -> None:
        """Drop one pin (the request copied the snapshot into its slot)."""
        with self._lock:
            if entry.pins > 0:
                entry.pins -= 1

    # -- updates -------------------------------------------------------------

    def insert(self, tokens, payload: Any) -> PrefixEntry:
        """Cache ``payload`` under ``tokens``; refreshes an existing entry."""
        toks = tuple(int(t) for t in tokens)
        if not toks:
            raise ValueError("cannot cache an empty prefix")
        with self._lock:
            existing = self._entries.get(toks)
            if existing is not None:
                existing.payload = payload
                existing.tick = next(self._clock)
                return existing
            entry = PrefixEntry(toks, payload)
            entry.tick = next(self._clock)
            self._insert_node(toks, entry)
            self._entries[toks] = entry
            while len(self._entries) > self.max_entries:
                if not self._evict_one():
                    break           # everything pinned: tolerate overflow
            return entry

    def _insert_node(self, toks: tuple[int, ...], entry: PrefixEntry) -> None:
        node, i = self._root, 0
        while i < len(toks):
            child = node.children.get(toks[i])
            if child is None:
                leaf = _Node(toks[i:])
                leaf.entry = entry
                node.children[toks[i]] = leaf
                return
            edge = child.edge
            common = 0
            while (common < len(edge) and i + common < len(toks)
                   and edge[common] == toks[i + common]):
                common += 1
            if common == len(edge):
                node, i = child, i + common
                continue
            # split the edge at the divergence point
            mid = _Node(edge[:common])
            child.edge = edge[common:]
            mid.children[child.edge[0]] = child
            node.children[toks[i]] = mid
            node, i = mid, i + common
        node.entry = entry

    def _evict_one(self) -> bool:
        victims = [e for e in self._entries.values() if e.pins == 0]
        if not victims:
            return False
        victim = min(victims, key=lambda e: e.tick)
        self._remove(victim.tokens)
        self.evictions += 1
        return True

    def _remove(self, toks: tuple[int, ...]) -> None:
        self._entries.pop(toks, None)
        path: list[tuple[_Node, _Node]] = []      # (parent, child) walked
        node, i = self._root, 0
        while i < len(toks):
            child = node.children.get(toks[i])
            if child is None or toks[i:i + len(child.edge)] != child.edge:
                return
            path.append((node, child))
            i += len(child.edge)
            node = child
        node.entry = None
        # prune entry-less leaf chains so the trie doesn't grow unboundedly
        for parent, child in reversed(path):
            if child.entry is None and not child.children:
                del parent.children[child.edge[0]]
            elif child.entry is None and len(child.children) == 1:
                # merge a pass-through node into its only child
                (only,) = child.children.values()
                only.edge = child.edge + only.edge
                parent.children[child.edge[0]] = only
            else:
                break

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "pinned": sum(1 for e in self._entries.values() if e.pins)}
