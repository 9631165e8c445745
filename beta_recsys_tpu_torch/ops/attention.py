"""Causal multi-head self-attention blocks for sequence recommenders.

Counterpart of ``beta_recsys_tpu/ops/attention.py`` (serving: no dropout).
Weights keep the JAX layout, (in, out), so a projection is ``x @ w``.
"""

import torch

from .kernels.flash_attention import flash_causal_attention, flash_causal_attention_reference


def layer_norm(x, scale, bias, eps=1e-8):
    """LayerNorm with eps inside the rsqrt and the biased variance, as the
    reference computes it (``torch.var`` defaults to the unbiased one)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def pointwise_ffn(x, p):
    """Conv1d(k=1) -> ReLU -> Conv1d(k=1) with residual."""
    h = torch.relu(x @ p["w1"] + p["b1"])
    return x + (h @ p["w2"] + p["b2"])


def causal_mha(q, k, v, n_heads, wq, wk, wv, wo, fused="auto"):
    """Causal multi-head attention: (B, T, D) -> (B, T, D).

    Heads split the model dim, (B, T, D) -> (B * H, T, dh). With
    ``fused="auto"`` or ``True`` the softmax(QK^T)V core goes through
    ``flash_causal_attention``: the hand-written kernel for a CUDA tensor, its
    plain version for a CPU tensor. ``False`` runs the plain version on
    either device.
    """
    B, T, D = q.shape
    dh = D // n_heads

    def split_heads(x, w):
        h = (x @ w).reshape(B, T, n_heads, dh)
        return h.transpose(1, 2).reshape(B * n_heads, T, dh)

    attend = flash_causal_attention if fused else flash_causal_attention_reference
    out, _ = attend(split_heads(q, wq), split_heads(k, wk), split_heads(v, wv))
    out = out.reshape(B, n_heads, T, dh).transpose(1, 2).reshape(B, T, D)
    return out @ wo
