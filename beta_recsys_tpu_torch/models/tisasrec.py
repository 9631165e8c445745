"""TiSASRec: time-interval-aware self-attention for sequential recommendation.

Counterpart of ``beta_recsys_tpu/models/tisasrec.py``: SASRec's blocks (LN on
the query -> attention, residual from the normalized query -> LN -> pointwise
FFN with dropout -> timeline mask) and final LN, with no position table:
learned absolute-position K and V rows (``abs_pos_k``, ``abs_pos_v``, the
last T of ``maxlen``) and learned rows over clipped per-pair time intervals
(``time_k``, ``time_v``, ``time_span + 1`` rows) feed the attention as
additive terms,

    attn = softmax_causal((Q K^T + Q pK^T + <tK[tm], Q>) / sqrt(dh))
    out  = attn V + attn pV + sum_k attn[., k] tV[tm[., k]].

The attention has no dropout; the embedding and the FFN do. The loss is
SASRec's masked BCE over (pos, neg) plus ``l2_emb`` times the Frobenius
norm (not squared) of the item table.

The JAX package gathers (B, T, T, D) tensors ``time_k[tm]`` and
``time_v[tm]``; ~17% of the structured split's intervals are clipped to
``time_span``, so their backward would sum a sixth of the rows into one
table row. Here the two time terms come from the (time_span + 1)-row tables
per head instead: the score term is ``Q_h @ time_k_h^T``, (B, h, T, S), read
at ``tm`` along its last axis; the value term sums the attention weights
into their interval buckets, (B, h, T, S), then multiplies by ``time_v_h``.
Both read and write through flat advanced indexing, whose backward on the
GPU sorts its indices and sums in that order (no atomics), so a seed
repeats bit for bit; each bucket takes at most T weights.

Parameter names and layouts follow the JAX params tree: ``item_emb`` (pad
row 0), ``abs_pos_k``, ``abs_pos_v``, ``time_k``, ``time_v``,
``blocks.<i>.{attn_ln,attn,ffn_ln,ffn}.*`` and ``last_ln.*``.
"""

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import inverted_dropout, layer_norm, pointwise_ffn
from .base import RecModel
from .sasrec import attention_blocks, init_attention_blocks

NEG_INF = -1e30


def bucket_flat_index(tm, n_heads, n_buckets):
    """(B, h, T, T) flat indices into a (B, h, T, n_buckets) tensor: entry
    (b, h, q, k) points at bucket ``tm[b, q, k]`` of row (b, h, q)."""
    B, T, _ = tm.shape
    rows = torch.arange(B * n_heads * T, device=tm.device).view(B, n_heads, T, 1) * n_buckets
    return rows + tm[:, None, :, :]


def time_aware_mha(blk, q, k, tm_flat, time_k, time_v, pos_k, pos_v, n_heads):
    """Time-aware attention: q, k (B, T, D); ``tm_flat`` from
    ``bucket_flat_index``; time_k/v (S, D) tables; pos_k/v (T, D)."""
    B, T, D = q.shape
    dh = D // n_heads
    S = time_k.shape[0]
    # Mixed precision: float32 activations promote the cast weights, as JAX
    # promotes each product (torch's matmul raises on mixed types).
    dt = torch.promote_types(q.dtype, blk["wq"].dtype)
    blk = {name: w.to(dt) for name, w in blk.items()}
    q, k, time_k, time_v, pos_k, pos_v = (x.to(dt) for x in (q, k, time_k, time_v, pos_k, pos_v))

    def heads(x):  # (B, T, D) -> (B, h, T, dh)
        return x.view(B, T, n_heads, dh).transpose(1, 2)

    Q, K, V = heads(q @ blk["wq"]), heads(k @ blk["wk"]), heads(k @ blk["wv"])
    pK, pV = pos_k.view(T, n_heads, dh).transpose(0, 1), pos_v.view(T, n_heads, dh).transpose(0, 1)
    tK, tV = time_k.view(S, n_heads, dh).transpose(0, 1), time_v.view(S, n_heads, dh).transpose(0, 1)
    logits = Q @ K.transpose(-1, -2) + Q @ pK.transpose(-1, -2)[None]
    logits = logits + (Q @ tK.transpose(-1, -2)[None]).reshape(-1)[tm_flat]
    logits = logits / math.sqrt(dh)
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(torch.where(causal, logits, NEG_INF), dim=-1)
    buckets = probs.new_zeros(B * n_heads * T * S).index_put((tm_flat.reshape(-1),), probs.reshape(-1),
                                                             accumulate=True)
    out = probs @ V + probs @ pV[None] + buckets.view(B, n_heads, T, S) @ tV[None]
    return out.transpose(1, 2).reshape(B, T, D) @ blk["wo"]


class TiSASRec(RecModel):
    batch_kind = "sequence_time"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.maxlen = int(config.get("maxlen", 50))
        self.time_span = int(config.get("time_span", 256))
        self.num_blocks = int(config.get("num_blocks", 2))
        self.num_heads = int(config.get("num_heads", 2))
        self.dropout_rate = float(config.get("dropout_rate", 0.1))
        self.l2_emb = float(config.get("l2_emb", 0.0))
        d, dev = self.emb_dim, self.device
        self.item_emb = nn.Parameter(torch.empty(n_items + 1, d, device=dev))
        self.abs_pos_k = nn.Parameter(torch.empty(self.maxlen, d, device=dev))
        self.abs_pos_v = nn.Parameter(torch.empty(self.maxlen, d, device=dev))
        self.time_k = nn.Parameter(torch.empty(self.time_span + 1, d, device=dev))
        self.time_v = nn.Parameter(torch.empty(self.time_span + 1, d, device=dev))
        self.blocks, self.last_ln = attention_blocks(d, self.num_blocks, dev)
        ctx, ctx_time = self.artifacts.get("ctx"), self.artifacts.get("ctx_time")
        self.ctx = None if ctx is None else torch.as_tensor(ctx, device=dev)
        self.ctx_time = None if ctx_time is None else torch.as_tensor(ctx_time, dtype=torch.long, device=dev)

    @torch.no_grad()
    def init_weights(self, generator):
        """The JAX initializer's distributions, drawn from a CPU
        ``torch.Generator``: normal(0, stddev) tables with a zero padding
        row, Xavier-uniform projections, the FFN's and LN's as SASRec's."""

        def draw(p, fn):
            host = torch.empty(p.shape)
            fn(host)
            p.copy_(host)

        for table in (self.item_emb, self.abs_pos_k, self.abs_pos_v, self.time_k, self.time_v):
            draw(table, lambda t: t.normal_(0.0, self.stddev, generator=generator))
        self.item_emb[0] = 0.0
        init_attention_blocks(self.blocks, self.last_ln, generator)
        return self

    def with_context(self, ctx, ctx_time=None):
        """A light copy (sharing the parameters) that scores against another
        context and, if given, its interval matrices."""
        clone = copy.copy(self)
        clone.ctx = torch.as_tensor(ctx, device=self.item_emb.device)
        if ctx_time is not None:
            clone.ctx_time = torch.as_tensor(ctx_time, dtype=torch.long, device=self.item_emb.device)
        return clone

    def seq2feats(self, log_seqs, time_matrices, generator=None, seq_emb_raw=None):
        """Encode (B, T) 1-indexed items and their (B, T, T) intervals ->
        (B, T, D) features. With a ``generator`` the embedding dropout, then
        per block FFN 1's and FFN 2's, are drawn from it in the JAX
        package's order. ``seq_emb_raw`` replaces the item-table lookup."""
        T = log_seqs.shape[1]
        raw = self.item_emb[log_seqs] if seq_emb_raw is None else seq_emb_raw
        # A float32 scale, as in the JAX model: it promotes cast rows.
        raw = raw.to(torch.promote_types(raw.dtype, torch.float32))
        seqs = inverted_dropout(generator, raw * math.sqrt(self.emb_dim), self.dropout_rate)
        tm_flat = bucket_flat_index(time_matrices.clamp(0, self.time_span), self.num_heads, self.time_span + 1)
        pos_k, pos_v = self.abs_pos_k[self.maxlen - T:], self.abs_pos_v[self.maxlen - T:]
        timeline = (log_seqs != 0)[..., None].to(seqs.dtype)
        seqs = seqs * timeline
        for blk in self.blocks:
            q = layer_norm(seqs, blk["attn_ln"]["scale"], blk["attn_ln"]["bias"])
            out = time_aware_mha(blk["attn"], q, seqs, tm_flat, self.time_k, self.time_v, pos_k, pos_v,
                                 self.num_heads)
            seqs = layer_norm(q + out, blk["ffn_ln"]["scale"], blk["ffn_ln"]["bias"])
            seqs = pointwise_ffn(seqs, blk["ffn"], self.dropout_rate, generator) * timeline
        return layer_norm(seqs, self.last_ln["scale"], self.last_ln["bias"])

    def loss(self, batch, generator=None):
        """Masked BCE-with-logits over (pos, neg) at every position, plus
        ``l2_emb`` times the Frobenius norm of the item table. One gather of
        [seq | pos | neg] serves the encoder input and both targets."""
        seq, pos, neg = batch["seq"], batch["pos"], batch["neg"]
        T = seq.shape[1]
        emb = self.item_emb[torch.cat([seq, pos, neg], dim=1)]
        feats = self.seq2feats(seq, batch["time_matrix"], generator, seq_emb_raw=emb[:, :T])
        pos_logits = (feats * emb[:, T:2 * T]).sum(dim=-1)
        neg_logits = (feats * emb[:, 2 * T:]).sum(dim=-1)
        mask = (pos != 0).to(torch.float32)
        n_valid = mask.sum().clamp(min=1.0)
        loss = ((F.softplus(-pos_logits) + F.softplus(neg_logits)) * mask).sum() / n_valid
        if self.l2_emb > 0:
            loss = loss + self.l2_emb * self.item_emb.square().sum().sqrt()
        return loss

    def _final_feats(self, users):
        if self.ctx is None or self.ctx_time is None:
            raise ValueError("TiSASRec needs artifacts['ctx'] and artifacts['ctx_time'] for scoring")
        return self.seq2feats(self.ctx[users], self.ctx_time[users])[:, -1, :]

    def score_candidates(self, users, cand_items):
        """(U,), (U, C) dense 0-indexed candidates -> (U, C) logits."""
        return torch.einsum("ud,ucd->uc", self._final_feats(users), self.item_emb[cand_items + 1])

    def score_all(self, users):
        return self._final_feats(users) @ self.item_emb[1:].T

    def score_pairs(self, users, items):
        """Per-pair scores against each user's context and intervals, each
        user's context encoded once (the JAX model's ``score_pairs`` calls
        its ``_final_feats`` without the intervals and raises)."""
        uniq, inv = torch.unique(users, return_inverse=True)
        return (self._final_feats(uniq)[inv] * self.item_emb[items + 1]).sum(dim=-1)
