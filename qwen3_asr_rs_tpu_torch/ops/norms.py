"""Normalization ops (port of ``qwen3_asr_rs_tpu/ops/norms.py``).

Both norms compute in float32 and cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm over the last axis: x / sqrt(mean(x^2) + eps) * weight."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with affine weight/bias."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    normed = (xf - mean) * (var + eps) ** -0.5
    return (normed * weight.float() + bias.float()).to(x.dtype)
