"""ServeStats: the engine's observable surface.

Counters are plain ints/floats updated by the step loop (single consumer
thread); derived rates are properties so a dashboard or test reads one
coherent snapshot via :meth:`ServeStats.as_dict`.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ServeStats"]


@dataclasses.dataclass
class ServeStats:
    # step counts. A verify step is one speculative round: γ+1 rows per
    # active request through one forward instead of one row per decode step.
    prefill_steps: int = 0
    decode_steps: int = 0
    verify_steps: int = 0
    # token accounting. Rows: what the hardware ran — prompt_tokens and
    # decode_real_rows are useful rows, *_padded_tokens the launched bucket
    # area (their gap is padding waste). generated_tokens counts every token
    # emitted to a caller (each request's first comes from its prefill step).
    # Under speculation a verify step launches (γ+1) rows per real request
    # (decode_real_rows) but emits only the accepted ones
    # (decode_emitted_tokens) — padding waste is judged on rows launched,
    # decode throughput on tokens emitted.
    prompt_tokens: int = 0
    generated_tokens: int = 0
    decode_real_rows: int = 0
    decode_emitted_tokens: int = 0
    prefill_padded_tokens: int = 0
    decode_padded_tokens: int = 0
    # speculative decoding: γ proposals per request per round; accepted is
    # how many survived verify (the bonus token is not counted as drafted)
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    # prefix cache: hits/misses counted per submitted request, reused tokens
    # skip prefill entirely
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_tokens_reused: int = 0
    # bucket reuse: a hit runs a step shape that is already prepared (warmed
    # or previously seen); a miss pays its first run, and on the card its
    # graph capture, mid-serve
    bucket_hits: int = 0
    bucket_misses: int = 0
    # warmup provenance
    warmed_shapes: int = 0
    warm_plans: int = 0
    t_warm: float = 0.0
    # phase wall-clock (step dispatch + device time, excludes warmup)
    t_prefill: float = 0.0
    t_decode: float = 0.0
    # request lifecycle
    requests_admitted: int = 0
    requests_finished: int = 0

    @property
    def steps(self) -> int:
        return self.prefill_steps + self.decode_steps + self.verify_steps

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens that survived verification."""
        return self.accepted_tokens / self.drafted_tokens \
            if self.drafted_tokens else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        total = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / total if total else 0.0

    @property
    def bucket_hit_rate(self) -> float:
        total = self.bucket_hits + self.bucket_misses
        return self.bucket_hits / total if total else 0.0

    @property
    def real_tokens(self) -> int:
        """Tokens that reached a caller: prompts consumed + tokens emitted."""
        return self.prompt_tokens + self.generated_tokens

    @property
    def real_rows(self) -> int:
        return self.prompt_tokens + self.decode_real_rows

    @property
    def padded_tokens(self) -> int:
        return self.prefill_padded_tokens + self.decode_padded_tokens

    @property
    def padding_waste(self) -> float:
        """Fraction of launched token-rows that were padding."""
        return 1.0 - self.real_rows / self.padded_tokens \
            if self.padded_tokens else 0.0

    @property
    def decode_tokens_per_s(self) -> float:
        """Tokens emitted by decode/verify steps per second of decode time
        (each request's first token comes from prefill and is excluded).
        Uses emitted tokens, not launched rows — under speculation a verify
        row that gets rejected is work done, not a token served."""
        return self.decode_emitted_tokens / self.t_decode \
            if self.t_decode else 0.0

    @property
    def tokens_per_s(self) -> float:
        """Real tokens processed per second of engine step time."""
        t = self.t_prefill + self.t_decode
        return self.real_tokens / t if t else 0.0

    def as_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d.update(
            steps=self.steps,
            bucket_hit_rate=round(self.bucket_hit_rate, 4),
            padding_waste=round(self.padding_waste, 4),
            tokens_per_s=round(self.tokens_per_s, 2),
            decode_tokens_per_s=round(self.decode_tokens_per_s, 2),
            acceptance_rate=round(self.acceptance_rate, 4),
            prefix_hit_rate=round(self.prefix_hit_rate, 4),
        )
        return d
