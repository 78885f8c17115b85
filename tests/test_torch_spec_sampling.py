"""Speculative sampling: the port's tokens and stats equal the JAX
engine's for the same seed (float32, the CPU), on the helpers of
``test_torch_spec_decode.py``: k = 3, a self-draft and a second-seed
cross-model draft, three seeds (``test_torch_sampled_parity.SAMPLINGS``).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
from qwen3_asr_rs_tpu.runtime.sampling import SamplingParams as JSampling
from qwen3_asr_rs_tpu_torch.runtime.sampling import SamplingParams

from test_torch_sampled_parity import SAMPLINGS
from test_torch_spec_decode import (
    VARIED,
    _draft_cfg,
    _draft_tuple,
    _engine,
    _jax_engine,
)


@pytest.mark.parametrize("case", ["self", "cross"])
def test_spec_sampling_matches_jax(case):
    """Speculative sampling (k = 3) gives the JAX engine's tokens and
    stats for three seeds: draft step i at ``fold_in(fold_in(key, iters +
    1), 2 + i)``, the accept at ``fold_in(key_it, 0)`` (its uniforms and
    its replacement draw folding in 0 and 1), on a self-draft (every
    draft accepted: the bonus draw) and on a second-seed cross-model draft
    (rejections: the residual draw)."""
    jkw, tkw = dict(spec_k=3), dict(spec_k=3)
    if case == "self":
        jkw["speculative"] = tkw["speculative"] = "bf16"
    else:
        jd = _draft_cfg(jconfig)
        jkw["draft_model"] = (jd, (
            init_encoder_params(jd.audio, dtype=jnp.float32),
            init_decoder_params(jd.text, dtype=jnp.float32, seed=7)))
        tkw["draft_model"] = _draft_tuple(_draft_cfg())
    samples = (np.random.default_rng(4).standard_normal(40000) * 0.1).astype(
        np.float32)
    jeng = _jax_engine(12, VARIED, **jkw)
    teng = _engine(max_new=12, scale=VARIED, **tkw)
    outs = set()
    for sp in SAMPLINGS:
        want = jeng.transcribe_samples(samples,
                                       sampling=JSampling(**sp)).raw_output
        got = teng.transcribe_samples(samples, sampling=SamplingParams(**sp))
        assert got.raw_output == want
        assert teng.last_spec_stats == jeng.last_spec_stats
        outs.add(want)
    assert len(outs) == 3
