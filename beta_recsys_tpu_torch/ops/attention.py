"""Causal multi-head self-attention blocks for sequence recommenders.

Counterpart of ``beta_recsys_tpu/ops/attention.py``. Weights keep the JAX
layout, (in, out), so a projection is ``x @ w``. Dropout follows the JAX
rule: no generator, no dropout. With a ``torch.Generator`` each dropout
draws from it in call order; ``dropout_mask`` is the one place a mask is
drawn outside the attention core, whose mask is the Philox mask of
``kernels/philox.py`` keyed on a seed drawn from the same generator. The
FFN's ReLU is ``activations.relu``.
"""

import torch

from ..core.mixed_precision import promoted
from . import activations
from .kernels.flash_attention import FlashCausalAttention, flash_causal_attention_reference


def _mm(x, w):
    """x @ w, a float32 operand promoting a bfloat16 one as JAX promotes
    them (mixed precision: float32 activations against cast weights)."""
    return torch.matmul(*promoted(x, w))


def layer_norm(x, scale, bias, eps=1e-8):
    """LayerNorm with eps inside the rsqrt and the biased variance, as the
    reference computes it (``torch.var`` defaults to the unbiased one)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def dropout_mask(generator, shape, rate, device):
    """Bool keep mask: each entry kept with probability 1 - rate."""
    return torch.rand(shape, generator=generator, device=device) >= rate


def inverted_dropout(generator, x, rate):
    """Inverted dropout: identity when generator is None or rate <= 0."""
    if generator is None or rate <= 0:
        return x
    keep = dropout_mask(generator, x.shape, rate, x.device)
    return torch.where(keep, x / (1 - rate), 0.0)


def dropout_seed(generator, device):
    """The attention dropout mask's seed, a (1,) int64 tensor drawn from
    ``generator`` on ``device``: it stays there, so drawing it waits on
    nothing."""
    return torch.randint(0, 2**62, (1,), generator=generator, device=device)


def pointwise_ffn(x, p, dropout_rate=0.0, generator=None):
    """Conv1d(k=1) -> ReLU -> [dropout] -> Conv1d(k=1) -> [dropout] with
    residual."""
    h = inverted_dropout(generator, activations.relu(_mm(x, p["w1"]) + p["b1"]), dropout_rate)
    h = inverted_dropout(generator, _mm(h, p["w2"]) + p["b2"], dropout_rate)
    return x + h


def causal_mha(q, k, v, n_heads, wq, wk, wv, wo, dropout_rate=0.0, generator=None, fused="auto"):
    """Causal multi-head attention: (B, T, D) -> (B, T, D).

    Heads split the model dim, (B, T, D) -> (B * H, T, dh). With
    ``fused="auto"`` or ``True`` the softmax(QK^T)[dropout]V core goes
    through ``FlashCausalAttention`` (the hand-written kernels forward and
    backward for a CUDA tensor, their plain versions for a CPU tensor);
    ``False`` runs the plain forward on either device and autograd through
    it. Attention dropout needs a generator, which draws the mask's seed.
    """
    B, T, D = q.shape
    dh = D // n_heads
    rate = dropout_rate if generator is not None else 0.0
    seed = dropout_seed(generator, q.device) if rate > 0 else None

    def split_heads(x, w):
        h = _mm(x, w).reshape(B, T, n_heads, dh)
        return h.transpose(1, 2).reshape(B * n_heads, T, dh)

    heads = (split_heads(q, wq), split_heads(k, wk), split_heads(v, wv))
    if fused:
        out = FlashCausalAttention.apply(*heads, seed, rate)
    else:
        out, _ = flash_causal_attention_reference(*heads, rate, seed)
    out = out.reshape(B, n_heads, T, dh).transpose(1, 2).reshape(B, T, D)
    return _mm(out, wo)
