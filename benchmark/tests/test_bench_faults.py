"""A whole run of each cell's harness on the CPU at tiny size, past the
look for a card, with the timed path broken underneath: ``correct`` has
to come out false for each fault that the cell can have, and true
without one. (One chip: no exchange between chips to leave out.)

Faults, planted in the program's decode step for the length of a run:
  token   a token altered where it is produced (the logits shifted by
          one vocabulary entry, so the step picks a neighbour of its
          best);
  stale   a step that returns its state unchanged (the pending token
          again);
  half    half of the batch left out (the first half of the rows takes
          the second half's logits).
"""

from __future__ import annotations

import pytest
import torch

from tiny import tiny_cell

from harness.runner import run_cell
from qwen3_asr_rs_tpu_torch.models.text_decoder import TextDecoder

SEED = 2 ** 31 + 77


def _half(x):
    """The first half of the rows left out: they take the second half's
    (a serving pool fills its slots from the first, so these are the
    rows in use)."""
    h = x.shape[0] // 2
    x = x.clone()
    x[:h] = x[x.shape[0] - h:]
    return x


def _faulty_logits(kind, logits, token_ids):
    if kind == "token":
        return logits.roll(1, -1)
    if kind == "stale":
        out = torch.full_like(logits, -1e4)
        out[torch.arange(len(token_ids)), token_ids.long()] = 1e4
        return out
    return _half(logits)


@pytest.fixture
def plant(monkeypatch):
    """plant(kind): break the decode steps that the serving segment
    (``decode_step`` at per-row positions) and the offline loop
    (``decode_step_aligned_token``) run."""

    def go(kind):
        step = TextDecoder.decode_step
        aligned = TextDecoder.decode_step_aligned

        def decode_step(self, params, token_ids, pos, cache, **kw):
            logits, cache = step(self, params, token_ids, pos, cache, **kw)
            return _faulty_logits(kind, logits, token_ids), cache

        def decode_step_aligned(self, params, token_ids, slot, kv_start,
                                cache, **kw):
            logits, cache = aligned(self, params, token_ids, slot, kv_start,
                                    cache, **kw)
            return _faulty_logits(kind, logits, token_ids), cache

        monkeypatch.setattr(TextDecoder, "decode_step", decode_step)
        monkeypatch.setattr(TextDecoder, "decode_step_aligned",
                            decode_step_aligned)

    return go


@pytest.mark.parametrize("kind", ["serve", "batch"])
def test_sound_run_is_correct(kind):
    out, values = run_cell(tiny_cell(kind), SEED, 2.0, False, "cpu")
    assert out["correct"], (out["checks"], values)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert values["tokens"] > 20


@pytest.mark.parametrize("fault", ["token", "stale", "half"])
@pytest.mark.parametrize("kind", ["serve", "batch"])
def test_broken_step_is_not_correct(plant, kind, fault):
    plant(fault)
    out, values = run_cell(tiny_cell(kind), SEED, 2.0, False, "cpu")
    assert not out["correct"], (out["checks"], values)
    assert out["checks"]["max_gap"]["value"] > 100 * out["checks"][
        "max_gap"]["limit"]
