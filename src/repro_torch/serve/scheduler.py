"""Continuous-batching scheduler: admission into slots, micro-batch formation.

The scheduler owns slot accounting and decides what the next step runs:

* **prefill-leaning, decode-fair** — whenever waiting requests (or unfinished
  prefill chunks) and capacity exist, the next step is a prefill micro-batch:
  keeping slots full is what decode throughput amortizes over. But prefill no
  longer starves decode: after ``max_consecutive_prefills`` prefill batches in
  a row, one decode batch runs if any slot is decode-ready — under a sustained
  arrival stream every in-flight request's inter-token gap is bounded by the
  cap instead of the queue depth (regression-tested in
  ``tests/test_torch_serve_spec.py``).
* **chunked prefill** — with ``prefill_chunk`` set, prompts longer than one
  bucket prefill in fixed full-bucket chunks across multiple micro-batches,
  each interleaved with decode work by the same fairness cap, so one long
  prompt stops inflating decode p99. Intermediate chunks are exactly the
  chunk bucket (no internal padding — the cache-validity exactness argument
  needs contiguously written positions); only the final chunk right-pads.
* otherwise, a decode micro-batch over every decode-ready slot, padded up to
  the decode batch bucket.

The scheduler never launches an off-grid shape: both work items carry their
padded (bucket) dimensions, so the engine's step graphs and the plan cache
key on a closed set of shapes.
"""
from __future__ import annotations

import dataclasses
import threading
import time

from repro_torch import trace

from .buckets import BucketPolicy
from .request import Request, RequestQueue

__all__ = ["PrefillWork", "DecodeWork", "Scheduler"]


@dataclasses.dataclass(frozen=True)
class PrefillWork:
    requests: tuple[Request, ...]
    slots: tuple[int, ...]          # one slot per request
    batch_pad: int                  # bucketed batch (>= len(requests))
    seq_pad: int                    # bucketed chunk length
    # per-row chunk geometry; defaults (derived in __post_init__) describe a
    # whole-prompt single-chunk prefill, the pre-chunking behavior
    starts: tuple[int, ...] = ()    # cache offset this chunk resumes at
    lengths: tuple[int, ...] = ()   # real tokens this chunk
    final: tuple[bool, ...] = ()    # does this chunk finish the prompt?

    def __post_init__(self):
        if not self.starts:
            object.__setattr__(self, "starts", (0,) * len(self.requests))
        if not self.lengths:
            object.__setattr__(
                self, "lengths", tuple(r.prompt_len for r in self.requests))
        if not self.final:
            object.__setattr__(self, "final", (True,) * len(self.requests))

    @property
    def real_tokens(self) -> int:
        return sum(self.lengths)

    @property
    def padded_tokens(self) -> int:
        return self.batch_pad * self.seq_pad


@dataclasses.dataclass(frozen=True)
class DecodeWork:
    requests: tuple[Request, ...]
    slots: tuple[int, ...]          # the active slots, |slots| == |requests|
    batch_pad: int                  # bucketed batch (>= len(slots))

    @property
    def real_tokens(self) -> int:
        return len(self.slots)

    @property
    def padded_tokens(self) -> int:
        return self.batch_pad


class Scheduler:
    """Admits requests into a fixed slot set and forms bucketed micro-batches."""

    def __init__(self, queue: RequestQueue, policy: BucketPolicy,
                 max_slots: int, *, max_consecutive_prefills: int = 2,
                 prefill_chunk: int | None = None):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if prefill_chunk is not None and prefill_chunk not in policy.prefill_seq:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be a prefill bucket "
                f"from {policy.prefill_seq} (intermediate chunks must be "
                "exactly full buckets)")
        self.queue = queue
        self.policy = policy
        self.max_slots = max_slots
        self.max_consecutive_prefills = max_consecutive_prefills
        self.prefill_chunk = prefill_chunk
        self._free = list(range(max_slots))[::-1]   # pop() -> lowest slot
        self._active: dict[int, Request] = {}
        self._prefill_run = 0                       # consecutive prefill batches
        self._lock = threading.Lock()

    # -- state -------------------------------------------------------------

    @property
    def n_active(self) -> int:
        with self._lock:
            return len(self._active)

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def idle(self) -> bool:
        return self.n_active == 0 and len(self.queue) == 0

    # -- step selection ----------------------------------------------------

    def next_work(self) -> PrefillWork | DecodeWork | None:
        """The next micro-batch to run, or None when idle.

        Decode-fairness cap: prefill still leads (slots should fill fast),
        but after ``max_consecutive_prefills`` prefill batches in a row a
        pending decode batch runs first — a continuous arrival stream can no
        longer starve in-flight decodes indefinitely.
        """
        decode = self._form_decode()
        if (decode is not None and self.max_consecutive_prefills
                and self._prefill_run >= self.max_consecutive_prefills):
            self._prefill_run = 0
            return decode
        work = self._form_prefill()
        if work is not None:
            self._prefill_run += 1
            return work
        self._prefill_run = 0
        return decode

    def _chunk_plan(self, r: Request) -> tuple[int, int, int, bool]:
        """(start, length, seq_pad, final) of ``r``'s next prefill chunk.

        A waiting request starts at its prefix-cache hit length; a running
        one resumes where the last chunk stopped. Chunks longer than the cap
        are cut to exactly the cap bucket (full, no pad); the final chunk
        pads to its own sequence bucket.
        """
        start = r.prefilled if r.state == "running" else r.prefix_len
        rem = r.prompt_len - start
        cap = self.prefill_chunk or self.policy.prefill_seq[-1]
        if rem > cap:
            return start, cap, cap, False
        return start, rem, self.policy.seq_bucket(rem), True

    def _form_prefill(self) -> PrefillWork | None:
        # 1) continuation chunks: partially-prefilled slots come first (they
        #    already hold a slot; finishing them is what unblocks decode)
        with self._lock:
            conts = [(s, r) for s, r in sorted(self._active.items())
                     if r.prefilled < r.prompt_len]
        if conts:
            return self._pack_chunks([r for _, r in conts],
                                     [s for s, _ in conts])
        # 2) fresh admissions from the queue head into free slots
        with self._lock:
            n_free = len(self._free)
        if n_free == 0:
            return None
        limit = min(n_free, self.policy.prefill_batch[-1])
        head = self.queue.peek(limit)
        if not head:
            return None
        # group the FIFO head while requests share the head's chunk bucket; a
        # longer prompt behind a short head waits for the next micro-batch
        # rather than inflating this one's bucket for everyone
        seq_pad = self._chunk_plan(head[0])[2]
        picked: list[Request] = []
        for r in head:
            if self._chunk_plan(r)[2] != seq_pad:
                break
            picked.append(r)
        self.queue.pop(picked)
        now = time.perf_counter()
        with self._lock:
            slots = [self._free.pop() for _ in picked]
            for s, r in zip(slots, picked):
                r.state, r.slot = "running", s
                r.prefilled = r.prefix_len
                r.admit_t = now
                self._active[s] = r
        for r in picked:
            trace.event("serve.queue", r.submit_t, now, rid=r.rid)
        return self._pack_chunks(picked, slots)

    def _pack_chunks(self, reqs: list[Request],
                     slots: list[int]) -> PrefillWork:
        """One PrefillWork from rows that share the first row's chunk bucket."""
        seq_pad = self._chunk_plan(reqs[0])[2]
        limit = self.policy.prefill_batch[-1]
        rows = []
        for r, s in zip(reqs, slots):
            plan = self._chunk_plan(r)
            if plan[2] != seq_pad:
                continue            # different bucket: next micro-batch's turn
            rows.append((r, s, plan))
            # advance at formation time: the engine runs this work before the
            # next next_work() call, and decode-readiness / the next chunk's
            # start are scheduler state, not engine state
            r.prefilled = plan[0] + plan[1]
            if len(rows) == limit:
                break
        reqs_t = tuple(r for r, _, _ in rows)
        return PrefillWork(
            requests=reqs_t,
            slots=tuple(s for _, s, _ in rows),
            batch_pad=self.policy.prefill_batch_bucket(len(rows)),
            seq_pad=seq_pad,
            starts=tuple(p[0] for _, _, p in rows),
            lengths=tuple(p[1] for _, _, p in rows),
            final=tuple(p[3] for _, _, p in rows))

    def _form_decode(self) -> DecodeWork | None:
        with self._lock:
            items = [(s, r) for s, r in sorted(self._active.items())
                     if r.prefilled >= r.prompt_len]
        if not items:
            return None
        slots = tuple(s for s, _ in items)
        reqs = tuple(r for _, r in items)
        return DecodeWork(requests=reqs, slots=slots,
                          batch_pad=self.policy.decode_batch_bucket(len(slots)))

    # -- completion --------------------------------------------------------

    def release(self, req: Request) -> None:
        """Return a finished request's slot to the free pool."""
        with self._lock:
            s = req.slot
            if self._active.get(s) is not req:
                raise ValueError(f"request {req.rid} does not own slot {s}")
            del self._active[s]
            self._free.append(s)
            req.slot = -1
