"""Causal multi-head self-attention blocks for sequence recommenders.

Counterpart of ``beta_recsys_tpu/ops/attention.py``. Weights keep the JAX
layout, (in, out), so a projection is ``x @ w``. Dropout follows the JAX
rule: no generator, no dropout. With a ``torch.Generator`` each dropout
draws from it in call order; ``dropout_mask`` is the one place a mask is
drawn outside the attention core, whose mask is the Philox mask of
``kernels/philox.py`` keyed on a seed drawn from the same generator.
``relu_keep`` is the one place the FFN's ReLU decides which entries pass,
so a check can hand one device's decisions to another, as it hands masks.
"""

import torch

from .kernels.flash_attention import FlashCausalAttention, flash_causal_attention_reference


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


def relu_keep(z):
    """Bool: the entries of ``z`` that ReLU passes (z > 0)."""
    return z > 0


def pointwise_ffn(x, p, dropout_rate=0.0, generator=None):
    """Conv1d(k=1) -> ReLU -> [dropout] -> Conv1d(k=1) -> [dropout] with
    residual. The ReLU is ``where(relu_keep(z), z, 0)``: the same values and
    gradient as ``torch.relu``."""
    z = x @ p["w1"] + p["b1"]
    h = inverted_dropout(generator, torch.where(relu_keep(z), z, 0.0), dropout_rate)
    h = inverted_dropout(generator, h @ p["w2"] + p["b2"], dropout_rate)
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
    # The mask's seed stays on the device: drawing it waits on nothing.
    seed = torch.randint(0, 2**62, (1,), generator=generator, device=q.device) if rate > 0 else None

    def split_heads(x, w):
        h = (x @ w).reshape(B, T, n_heads, dh)
        return h.transpose(1, 2).reshape(B * n_heads, T, dh)

    heads = (split_heads(q, wq), split_heads(k, wk), split_heads(v, wv))
    if fused:
        out = FlashCausalAttention.apply(*heads, seed, rate)
    else:
        out, _ = flash_causal_attention_reference(*heads, rate, seed)
    out = out.reshape(B, n_heads, T, dh).transpose(1, 2).reshape(B, T, D)
    return out @ wo
