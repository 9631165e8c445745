"""SASRec: causal self-attention over item sequences (serving and training).

Counterpart of ``beta_recsys_tpu/models/sasrec.py``: an item table with
padding row 0 (n_items + 1 rows) scaled by sqrt(d), learned position
embeddings, ``num_blocks`` of [LN on the query -> causal MHA, residual from
the normalized query -> LN -> pointwise FFN] with timeline masking, and a final
LN. Candidate scoring reads each user's context row (``artifacts["ctx"]``,
1-indexed items, left-padded); dense 0-indexed candidate ids are shifted +1.
Training scores every position against its next item and a sampled negative
(``loss``), with dropout drawn from the ``torch.Generator`` it is given.

``"compute_dtype": "bfloat16"`` in the model config casts the float32
parameters to bfloat16 inside ``log2feats``, in training and in serving, so
the attention runs in bfloat16 (the flash kernels' bfloat16 path on the
card); the scores are products of those features with the float32 item
table, promoted to float32 as the JAX package promotes them.

Parameter names and layouts follow the JAX params tree: ``item_emb``,
``pos_emb``, ``blocks.<i>.{attn_ln,attn,ffn_ln,ffn}.*`` and ``last_ln.*``,
with projection weights as (in, out) (``convert.py``).
"""

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.mixed_precision import promoted
from ..ops.attention import causal_mha, inverted_dropout, layer_norm, pointwise_ffn
from .base import RecModel


def _params(device, **shapes):
    return nn.ParameterDict(
        {name: nn.Parameter(torch.empty(shape, device=device)) for name, shape in shapes.items()}
    )


def attention_blocks(d, num_blocks, device):
    """(blocks, last_ln): ``num_blocks`` of {attn_ln, attn, ffn_ln, ffn}
    parameters and the final LN's, the JAX tree's ``blocks`` and
    ``last_ln``."""
    blocks = nn.ModuleList(
        nn.ModuleDict(
            {
                "attn_ln": _params(device, scale=(d,), bias=(d,)),
                "attn": _params(device, wq=(d, d), wk=(d, d), wv=(d, d), wo=(d, d)),
                "ffn_ln": _params(device, scale=(d,), bias=(d,)),
                "ffn": _params(device, w1=(d, d), b1=(d,), w2=(d, d), b2=(d,)),
            }
        )
        for _ in range(num_blocks)
    )
    return blocks, _params(device, scale=(d,), bias=(d,))


@torch.no_grad()
def init_attention_blocks(blocks, last_ln, generator):
    """Xavier-uniform projections drawn in order on the host, zero biases
    and unit LN scales."""
    for name, p in [*blocks.named_parameters(), *last_ln.named_parameters()]:
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("w"):
            p.copy_(nn.init.xavier_uniform_(torch.empty(p.shape), generator=generator))
        elif leaf.startswith("b"):
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)


class SASRec(RecModel):
    batch_kind = "sequence"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.maxlen = int(config.get("maxlen", 200))
        self.num_blocks = int(config.get("num_blocks", 2))
        self.num_heads = int(config.get("num_heads", 2))
        self.dropout_rate = float(config.get("dropout_rate", 0.1))
        self.l2_emb = float(config.get("l2_emb", 0.0))
        # "auto"/True: the flash kernel on CUDA tensors, its plain version on CPU
        # tensors; False: the plain version on either.
        self.fused_attention = config.get("fused_attention", "auto")
        # Read from the model section only, as the JAX model reads it.
        self.compute_dtype = torch.bfloat16 if config.get("compute_dtype") == "bfloat16" else torch.float32
        d, dev = self.emb_dim, self.device
        self.item_emb = nn.Parameter(torch.empty(n_items + 1, d, device=dev))
        self.pos_emb = nn.Parameter(torch.empty(self.maxlen, d, device=dev))
        self.blocks, self.last_ln = attention_blocks(d, self.num_blocks, dev)
        ctx = self.artifacts.get("ctx")
        self.ctx = None if ctx is None else torch.as_tensor(ctx, device=dev)

    @torch.no_grad()
    def init_weights(self, generator):
        """The reference initializer, drawn from a CPU ``torch.Generator``:
        normal(0, stddev) embeddings with a zero padding row, Xavier-uniform
        projections, zero biases and unit LN scales."""

        def draw(p, fn):
            host = torch.empty(p.shape)
            fn(host)
            p.copy_(host)

        draw(self.item_emb, lambda t: t.normal_(0.0, self.stddev, generator=generator))
        self.item_emb[0] = 0.0
        draw(self.pos_emb, lambda t: t.normal_(0.0, self.stddev, generator=generator))
        init_attention_blocks(self.blocks, self.last_ln, generator)
        return self

    def with_context(self, ctx):
        """A light copy (sharing the parameters) that scores against another
        per-user context matrix, e.g. train+valid for the final test."""
        clone = copy.copy(self)
        clone.ctx = torch.as_tensor(ctx, device=self.item_emb.device)
        return clone

    def log2feats(self, log_seqs, generator=None, seq_emb_raw=None):
        """Encode (B, T) 1-indexed item sequences -> (B, T, D) features.

        With a ``generator`` the embedding, attention and FFN dropouts are
        drawn from it in the JAX package's order: the embedding, then per
        block the attention probabilities, FFN 1 and FFN 2. ``seq_emb_raw``
        replaces the item-table lookup with pre-gathered unscaled rows (the
        loss shares one gather between inputs and targets). With a bfloat16
        ``compute_dtype`` the float32 parameters and rows are cast first."""
        dt = self.compute_dtype

        def cast(p):
            return p.to(dt) if p.dtype == torch.float32 else p

        def group(params):
            return {name: cast(p) for name, p in params.items()}

        T = log_seqs.shape[1]
        raw = cast(self.item_emb[log_seqs] if seq_emb_raw is None else seq_emb_raw)
        # sqrt(d) in the model's compute type, as the JAX model rounds it. A
        # float32 scale promotes rows that an engine-level cast made bfloat16
        # (JAX promotes; torch would keep a 0-d operand's type out of it).
        raw = raw.to(torch.promote_types(raw.dtype, dt))
        seqs = raw * torch.tensor(math.sqrt(self.emb_dim), dtype=dt)
        seqs = seqs + cast(self.pos_emb)[None, self.maxlen - T:, :]
        seqs = inverted_dropout(generator, seqs, self.dropout_rate)
        timeline = (log_seqs != 0)[..., None].to(seqs.dtype)
        seqs = seqs * timeline
        for blk in self.blocks:
            ln, attn, ffn_ln = group(blk["attn_ln"]), group(blk["attn"]), group(blk["ffn_ln"])
            q = layer_norm(seqs, ln["scale"], ln["bias"])
            attn_out = causal_mha(
                q, seqs, seqs, self.num_heads,
                attn["wq"], attn["wk"], attn["wv"], attn["wo"],
                dropout_rate=self.dropout_rate, generator=generator, fused=self.fused_attention,
            )
            seqs = q + attn_out
            seqs = layer_norm(seqs, ffn_ln["scale"], ffn_ln["bias"])
            seqs = pointwise_ffn(seqs, group(blk["ffn"]), self.dropout_rate, generator) * timeline
        last_ln = group(self.last_ln)
        return layer_norm(seqs, last_ln["scale"], last_ln["bias"])

    def loss(self, batch, generator=None):
        """Masked BCE-with-logits over (pos, neg) at every position, plus
        ``l2_emb`` times the Frobenius norm (not squared) of the item table.

        ``pos`` is ``seq`` shifted by one, so one gather of the (B, T+1)
        extended sequence serves the encoder input and the positive targets;
        where the two differ, pos is padding, which the mask zeroes."""
        seq, pos, neg = batch["seq"], batch["pos"], batch["neg"]
        ext_emb = self.item_emb[torch.cat([seq, pos[:, -1:]], dim=1)]
        feats = self.log2feats(seq, generator, seq_emb_raw=ext_emb[:, :-1])
        valid = pos != 0
        pos_emb = torch.where(valid[..., None], ext_emb[:, 1:], 0.0)
        pos_logits = (feats * pos_emb).sum(dim=-1)
        neg_logits = (feats * self.item_emb[neg]).sum(dim=-1)
        mask = valid.to(torch.float32)
        n_valid = mask.sum().clamp(min=1.0)
        loss = ((F.softplus(-pos_logits) + F.softplus(neg_logits)) * mask).sum() / n_valid
        if self.l2_emb > 0:
            loss = loss + self.l2_emb * self.item_emb.square().sum().sqrt()
        return loss

    def _final_feats(self, users):
        if self.ctx is None:
            raise ValueError("SASRec needs artifacts['ctx'] for scoring")
        return self.log2feats(self.ctx[users])[:, -1, :]

    def score_candidates(self, users, cand_items):
        """(U,), (U, C) dense 0-indexed candidates -> (U, C) logits."""
        return torch.einsum("ud,ucd->uc", *promoted(self._final_feats(users), self.item_emb[cand_items + 1]))

    def score_all(self, users):
        final, table = promoted(self._final_feats(users), self.item_emb[1:])
        return final @ table.T

    def score_pairs(self, users, items):
        """Per-pair scores against each user's context (Recommender.predict)."""
        final = self._final_feats(users)
        return (final * self.item_emb[items + 1]).sum(dim=-1)
