"""``correct`` comes out false when the timed path is broken underneath
(the harness's look for a card skipped: the smoke cell on the CPU), once for
each fault the cell can have, and the float8 control, put in the
program's place and judged by the same code, comes out not correct.
A one-chip served cell has no exchange between chips to leave out."""
from __future__ import annotations

import pytest
import torch
from conftest import run_tiny


def freeze_state(engine):
    """Every step returns the engine's cache as it found it."""
    for step in engine.graphs.steps.values():
        def frozen(_fn=step.fn, **inputs):
            saved = {k: c.clone() for k, c in engine.cache.items()}
            out = _fn(**inputs)
            for k, c in engine.cache.items():
                c.copy_(saved[k])
            return out
        step.fn = frozen


def drop_half_the_rows(engine):
    """Each step computes the first half of its rows; the rest repeat them."""
    for step in engine.graphs.steps.values():
        def halved(_fn=step.fn, **inputs):
            greedy, logits = _fn(**inputs)
            h = (greedy.shape[0] + 1) // 2
            idx = torch.arange(greedy.shape[0]) % h
            return greedy[idx], logits[idx]
        step.fn = halved


def alter_tokens(engine):
    """Every emitted token is moved by one where it is produced."""
    emit = engine._emit

    def altered(req, tok, logits_row=None):
        return emit(req, (tok + 1) % engine.cfg.vocab_size, logits_row)
    engine._emit = altered


def test_sound_program_is_correct(tiny_cell):
    result, log = run_tiny(tiny_cell)
    assert result["correct"], result["checked"]


@pytest.mark.parametrize("fault", [freeze_state, drop_half_the_rows, alter_tokens],
                         ids=["state_unchanged", "half_the_rows", "token_altered"])
def test_a_fault_makes_correct_false(tiny_cell, fault):
    result, log = run_tiny(tiny_cell, tamper=fault)
    assert not result["correct"]
    assert result["checked"]["logit_gap"]["value"] > result["checked"]["logit_gap"]["limit"]


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_float8_control_reads_past_the_limit(tiny_cell, seed):
    result, log = run_tiny(tiny_cell, seed=seed, control=True)
    assert result["correct"]
    ctl = log["control"]
    assert ctl["correct"] is False
    assert ctl["checked"]["logit_gap"]["value"] > ctl["checked"]["logit_gap"]["limit"]
    assert ctl["checked"]["served_tokens"] == result["checked"]["served_tokens"]
