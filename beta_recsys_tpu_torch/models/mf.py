"""Matrix factorization with user, item and global biases.

Counterpart of ``beta_recsys_tpu/models/mf.py``: score =
sigmoid(u.i + b_u + b_i + b_g); BPR or BCE loss on the sigmoid scores; an L2
term over the looked-up rows divided by the batch size, weighted by ``reg``.
Parameter names and shapes follow the JAX params tree (``user_emb``,
``item_emb``, ``user_bias``, ``item_bias`` and a 0-d ``global_bias``), so
``convert.py`` carries checkpoints across either way. Rows are looked up by
plain indexing: the JAX package's one-hot-matmul lookup (``ops/gather.py``)
is a TPU technique with the same values.
"""

import torch
from torch import nn

from .base import RecModel
from .losses import bce_loss, bpr_loss, l2_reg


class MF(RecModel):
    """Biased matrix factorization."""

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.loss_type = config.get("loss", "bpr")
        self.reg = float(config.get("reg", 0.0))
        d, dev = self.emb_dim, self.device
        self.user_emb = nn.Parameter(torch.empty(n_users, d, device=dev))
        self.item_emb = nn.Parameter(torch.empty(n_items, d, device=dev))
        self.user_bias = nn.Parameter(torch.zeros(n_users, device=dev))
        self.item_bias = nn.Parameter(torch.zeros(n_items, device=dev))
        self.global_bias = nn.Parameter(torch.zeros((), device=dev))

    @torch.no_grad()
    def init_weights(self, generator):
        """normal(0, stddev) embeddings drawn from a CPU ``torch.Generator``,
        zero biases (the JAX package's ``init_params``)."""
        for p in (self.user_emb, self.item_emb):
            p.copy_(torch.empty(p.shape).normal_(0.0, self.stddev, generator=generator))
        for p in (self.user_bias, self.item_bias, self.global_bias):
            p.zero_()
        return self

    def user_item_embeddings(self):
        """Bias-augmented factorized form for retrieval: [u, 1, b_u] . [i, b_i, 1]
        = u.i + b_u + b_i, which ranks as the sigmoid score does."""
        u, i = self.user_emb, self.item_emb
        u_ext = torch.cat([u, torch.ones_like(u[:, :1]), self.user_bias[:, None]], dim=1)
        i_ext = torch.cat([i, self.item_bias[:, None], torch.ones_like(i[:, :1])], dim=1)
        return u_ext, i_ext

    def retrieval_score_transform(self, scores):
        """The factorized form omits the global bias and the sigmoid; put both
        back so retrieval scores match ``score_pairs``."""
        return torch.sigmoid(scores + self.global_bias)

    def score_pairs(self, users, items):
        logits = (
            (self.user_emb[users] * self.item_emb[items]).sum(dim=-1)
            + self.user_bias[users] + self.item_bias[items] + self.global_bias
        )
        return torch.sigmoid(logits)

    def score_candidates(self, users, cand_items):
        """Through ``score_pairs``, as the JAX MF scores candidates (not the
        factorized default, which omits the sigmoid and the global bias)."""
        users_b = users[:, None].expand(cand_items.shape)
        return self.score_pairs(users_b, cand_items)

    def score_all(self, users):
        logits = (
            self.user_emb[users] @ self.item_emb.T
            + self.user_bias[users][:, None]
            + self.item_bias[None, :]
            + self.global_bias
        )
        return torch.sigmoid(logits)

    def _reg_term(self, users, items):
        return l2_reg(
            self.user_emb[users], self.item_emb[items], self.user_bias[users],
            self.item_bias[items], batch_size=users.shape[0],
        )

    def loss(self, batch, generator=None):
        """The batch's training loss (the dense trainers differentiate it; MF
        draws no dropout, so ``generator`` is unused)."""
        if self.loss_type == "bpr":
            users, pos, neg = batch["users"], batch["pos_items"], batch["neg_items"]
            loss = bpr_loss(self.score_pairs(users, pos), self.score_pairs(users, neg))
            reg = self._reg_term(users, pos) + self._reg_term(users, neg)
        elif self.loss_type == "bce":
            users, items, labels = batch["users"], batch["items"], batch["labels"]
            loss = bce_loss(self.score_pairs(users, items), labels)
            reg = self._reg_term(users, items)
        else:
            raise ValueError(f"Unsupported loss {self.loss_type}; use 'bpr' or 'bce'")
        return loss + self.reg * reg

    @property
    def batch_kind(self):
        return "pairwise" if self.loss_type == "bpr" else "pointwise"

    # -- sparse-optimizer protocol (core/sparse_optim.py) -------------------------

    def row_tables(self):
        """Sparse tables -> the batch ids that index them ("items_cat" = the
        positives, then the negatives)."""
        return {"user_emb": "users", "item_emb": "items_cat", "user_bias": "users", "item_bias": "items_cat"}

    def row_loss(self, rows, dense_params, batch):
        """BPR loss from gathered rows only (no table-sized tensors). As in
        the JAX package, the L2 term counts the user rows once and the item
        rows over all 2B rows, unlike ``loss``, which counts the users twice."""
        B = batch["users"].shape[0]
        u_emb, i_emb = rows["user_emb"], rows["item_emb"]  # (B, d), (2B, d)
        u_bias, i_bias = rows["user_bias"], rows["item_bias"]
        g = dense_params["global_bias"]
        pos_scores = torch.sigmoid((u_emb * i_emb[:B]).sum(dim=-1) + u_bias + i_bias[:B] + g)
        neg_scores = torch.sigmoid((u_emb * i_emb[B:]).sum(dim=-1) + u_bias + i_bias[B:] + g)
        loss = bpr_loss(pos_scores, neg_scores)
        if self.reg:
            loss = loss + self.reg * l2_reg(u_emb, i_emb, u_bias, i_bias, batch_size=B)
        return loss
