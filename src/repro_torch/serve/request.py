"""Serving requests and the thread-safe admission queue.

A :class:`Request` is one generation job: a prompt, a token budget, and the
mutable per-request state the engine fills in (generated tokens, slot, phase
timestamps). The :class:`RequestQueue` is the front door — callers submit
from any thread; the scheduler drains FIFO batches from the step loop.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue as _queue
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator, Sequence

__all__ = ["Request", "RequestQueue"]

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request plus its serving-time state."""

    prompt: Sequence[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))
    # -- engine-owned state ------------------------------------------------
    state: str = "waiting"              # waiting | running | done
    generated: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1                      # engine slot while running
    submit_t: float = dataclasses.field(default_factory=time.perf_counter)
    admit_t: float | None = None        # first handed out in a prefill micro-batch
    first_token_t: float | None = None  # time-to-first-token source
    finish_t: float | None = None
    logits: list = dataclasses.field(default_factory=list)  # engine record mode
    # chunked prefill / prefix reuse progress
    prefilled: int = 0                  # prompt tokens already in slot KV
    prefix_len: int = 0                 # of which: reused from the prefix cache
    prefix_entry: Any = None            # pinned PrefixEntry until loaded
    # streaming: per-token callback and/or a consumer-side iterator queue
    on_token: Callable[["Request", int], None] | None = None
    stream_q: _queue.Queue | None = None

    def __post_init__(self):
        self.prompt = [int(t) for t in self.prompt]
        if not self.prompt:
            raise ValueError("Request needs a non-empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.state == "done"

    @property
    def tokens(self) -> list[int]:
        """Prompt + generation, the full sequence so far."""
        return list(self.prompt) + self.generated

    def token_stream(self, timeout: float | None = None) -> Iterator[int]:
        """Yield generated tokens as the engine emits them.

        Only for requests submitted with ``stream=True``; the engine pushes
        each token into ``stream_q`` from ``_emit`` and a ``None`` sentinel
        on completion. Safe to consume from any thread while the engine's
        step loop runs elsewhere.
        """
        if self.stream_q is None:
            raise ValueError(
                f"request {self.rid} was not submitted with stream=True")
        while True:
            tok = self.stream_q.get(timeout=timeout)
            if tok is None:
                return
            yield tok


class RequestQueue:
    """Thread-safe FIFO of waiting requests.

    ``submit`` may be called from any thread (a frontend handler); ``peek`` /
    ``pop`` are the scheduler's side and preserve arrival order — bucket
    grouping never reorders across the queue head, it only limits how far a
    micro-batch extends.
    """

    def __init__(self):
        self._q: deque[Request] = deque()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def submit(self, req: Request) -> Request:
        if req.state != "waiting":
            raise ValueError(f"request {req.rid} already {req.state}")
        with self._lock:
            self._q.append(req)
        return req

    def peek(self, n: int) -> list[Request]:
        """The first ``n`` waiting requests (no removal)."""
        with self._lock:
            return list(itertools.islice(self._q, n))

    def pop(self, requests: list[Request]) -> None:
        """Remove specific requests (the subset a micro-batch admitted)."""
        with self._lock:
            picked = set(id(r) for r in requests)
            self._q = deque(r for r in self._q if id(r) not in picked)
