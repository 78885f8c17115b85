"""Seeded sampled transcripts: the port's tokens equal the JAX package's.

Both engines draw from JAX's threefry stream (``ops/prng.py``), so the
same ``SamplingParams(seed=...)`` gives the same transcript, float32 on
the CPU: ``transcribe_samples`` (B = 1) and ``transcribe_batch`` of 3
clips (padded to 4, a born-done pad row) on ``tiny_test_config()`` with
the full vocabulary and on the real 0.6B widths at two layers, for three
seeds at temperatures 0.7 to 1.0 with top-k and top-p on. Speculative
sampling's parity is in ``test_torch_spec_sampling.py``, serving's in
``test_torch_serving.py``, the dp = 2 mesh's in ``test_torch_parallel.py``.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import pytest
import torch

from qwen3_asr_rs_tpu.runtime.sampling import SamplingParams as JSampling
from qwen3_asr_rs_tpu_torch.runtime.sampling import SamplingParams

from test_torch_engine import _engines, _real2
from test_torch_serving import clip, engines

SAMPLINGS = [dict(temperature=0.7, top_k=50, top_p=0.9, seed=0),
             dict(temperature=0.85, top_k=20, top_p=0.95, seed=1),
             dict(temperature=1.0, top_k=0, top_p=0.8, seed=2**40 + 9)]
CLIPS = [clip(120, 20000), clip(121, 9000), clip(122, 30000)]


def _pair(name):
    if name == "tiny":
        p = engines(max_new=12)
        return p.jax, p.port
    return _engines(_real2, jnp.float32, torch.float32, 8, (1, 2))


@pytest.mark.parametrize("name", ["tiny", "real dims 2 layers"])
def test_sampled_transcripts_match_jax(name):
    jeng, teng = _pair(name)
    outs = set()
    for sp in SAMPLINGS:
        want = jeng.transcribe_samples(CLIPS[0], sampling=JSampling(**sp))
        got = teng.transcribe_samples(CLIPS[0], sampling=SamplingParams(**sp))
        assert got.raw_output == want.raw_output
        outs.add(want.raw_output)
        want = [r.raw_output for r in jeng.transcribe_batch(
            CLIPS, sampling=JSampling(**sp))]
        got = [r.raw_output for r in teng.transcribe_batch(
            CLIPS, sampling=SamplingParams(**sp))]
        assert got == want
        assert teng.last_stats["n_gen"][3] == 0  # the pad row
    greedy = teng.transcribe_samples(CLIPS[0]).raw_output
    assert len(outs) == 3 and greedy not in outs
