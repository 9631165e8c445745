"""CMN: a collaborative memory network, multi-hop attention over the users
of the scored item.

Counterpart of ``beta_recsys_tpu/models/cmn.py``. For a (user u, item i)
pair, hop 1 attends with z = m_u + e_i over the memories of i's training
users (``artifacts["item_neighbors"]``, padded with user 0 past
``artifacts["item_nb_len"]``, whose slots score -1e30 before the softmax)
and reads o from their output memories; each later hop takes z =
relu(z @ w + b + o) through its ``hop_maps`` entry. The score is
relu([m_u * e_i, o] @ dense_w + dense_b) @ out_w; the loss BPR plus
``training_l2_lambda`` times the Frobenius norms of ``dense_w``, ``out_w``
and each hop's ``w``. The memories start from a PairwiseGMF's
(``artifacts["user_embeddings"]``, ``["item_embeddings"]``), bit for bit,
when given. Parameter names and layouts follow the JAX params tree:
``user_memory``, ``item_memory``, ``user_output``, ``hop_maps.<h>.{w, b}``,
``dense_w`` (2d, d), ``dense_b``, ``out_w`` (d, 1), weights applied as
``x @ w``.

Scoring outside autograd runs in blocks of pairs whose two (pairs, M, d)
gathers stay within ``SCORE_BLOCK_BYTES``: M is the largest item's count of
training users, 614 on the structured split, so the 95,243 candidates of an
evaluation would gather 11.7 GB a table in one call.
"""

import numpy as np
import torch
from torch import nn

from .base import RecModel
from .lightgcn import xavier_uniform_
from .losses import bpr_loss
from .mlp import dense, he_normal_
from .pairwise_gmf import truncated_normal_

NEG_INF = -1e30  # not -inf: a row with no valid slot stays finite
SCORE_BLOCK_BYTES = 1 << 30


def build_item_neighborhoods(train_csr, max_neighbors=None):
    """(neighbours (n_items, M) int32, lengths (n_items,) int32): each item's
    training users in CSC order, padded with 0, M the largest count (at
    least 1) or ``max_neighbors``."""
    csc = train_csr.tocsc()
    n_items = csc.shape[1]
    lens = np.diff(csc.indptr)
    m = int(max_neighbors or max(lens.max(), 1))
    nb = np.zeros((n_items, m), dtype=np.int32)
    for i in range(n_items):
        users = csc.indices[csc.indptr[i]: csc.indptr[i + 1]][:m]
        nb[i, : len(users)] = users
    return nb, np.minimum(lens, m).astype(np.int32)


def _with_pad_rows(table, m):
    """``table`` with ``m`` copies of its row 0 appended."""
    return torch.cat([table, table[:1].expand(m, -1)])


class CMN(RecModel):
    batch_kind = "pairwise"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.hops = int(config.get("hops", 2))
        self.l2_lambda = float(config.get("training_l2_lambda", 0.1))
        if "item_neighbors" not in self.artifacts:
            raise ValueError("CMN attends over artifacts['item_neighbors'] (build_item_neighborhoods): build it "
                             "with the data (load(model_dir, data) needs data=)")
        dev = self.device
        self.item_neighbors = torch.as_tensor(np.asarray(self.artifacts["item_neighbors"]), dtype=torch.long,
                                              device=dev)
        self.item_nb_len = torch.as_tensor(np.asarray(self.artifacts["item_nb_len"]), dtype=torch.long, device=dev)
        d = self.emb_dim
        self.user_memory = nn.Parameter(torch.empty(n_users, d, device=dev))
        self.item_memory = nn.Parameter(torch.empty(n_items, d, device=dev))
        self.user_output = nn.Parameter(torch.empty(n_users, d, device=dev))
        self.hop_maps = nn.ModuleList(dense(d, d, dev) for _ in range(self.hops - 1))
        self.dense_w = nn.Parameter(torch.empty(2 * d, d, device=dev))
        self.dense_b = nn.Parameter(torch.empty(d, device=dev))
        self.out_w = nn.Parameter(torch.empty(d, 1, device=dev))

    @torch.no_grad()
    def init_weights(self, generator):
        """The pretrained memories where given (bit for bit), else truncated
        normal (0.01);
        truncated-normal output memories, He-normal ``dense_w`` and hop
        weights, ones for their biases, a Xavier-uniform ``out_w``; drawn
        from a CPU ``torch.Generator``."""
        for p, key in ((self.user_memory, "user_embeddings"), (self.item_memory, "item_embeddings")):
            # Drawn either way, so a warm start leaves every other draw as it was.
            p.copy_(truncated_normal_(torch.empty(p.shape), 0.01, generator))
            pre = self.artifacts.get(key)
            if pre is not None:
                p.copy_(pre if torch.is_tensor(pre) else torch.as_tensor(np.asarray(pre)))
        self.user_output.copy_(truncated_normal_(torch.empty(self.user_output.shape), 0.01, generator))
        self.dense_w.copy_(he_normal_(torch.empty(self.dense_w.shape), generator))
        self.dense_b.fill_(1.0)
        self.out_w.copy_(xavier_uniform_(torch.empty(self.out_w.shape), generator))
        for hop in self.hop_maps:
            hop["w"].copy_(he_normal_(torch.empty(hop["w"].shape), generator))
            hop["b"].fill_(1.0)
        return self

    def _memory_attention(self, users, items):
        """Multi-hop attention over each item's training users -> (B, d)."""
        nb = self.item_neighbors[items]  # (B, M) user ids, 0-padded
        slot = torch.arange(nb.shape[1], device=nb.device)
        slot_valid = slot < self.item_nb_len[items][:, None]
        # A padding slot reads user 0's rows, as in the JAX package, but
        # through a copy of them of its own (row n_users + slot): a gather's
        # backward sums the gradients of one id one after another, and most
        # slots are padding (M 614 against a mean of 58 users an item).
        spread = torch.where(slot_valid, nb, self.n_users + slot)
        mem, out_mem = (_with_pad_rows(t, nb.shape[1])[spread] for t in (self.user_memory, self.user_output))
        z = self.user_memory[users] + self.item_memory[items]
        o = None
        for h in range(self.hops):
            if h > 0:
                hop = self.hop_maps[h - 1]
                z = torch.relu(z @ hop["w"] + hop["b"] + o)
            scores = torch.einsum("bd,bmd->bm", z, mem).masked_fill(~slot_valid, NEG_INF)
            o = torch.einsum("bm,bmd->bd", torch.softmax(scores, dim=-1), out_mem)
        return o

    def _score(self, users, items):
        pointwise = self.user_memory[users] * self.item_memory[items]
        neighbor = self._memory_attention(users, items)
        h = torch.relu(torch.cat([pointwise, neighbor], dim=-1) @ self.dense_w + self.dense_b)
        return (h @ self.out_w)[..., 0]

    def score_pairs(self, users, items):
        """Aligned pairs of any shape; outside autograd in blocks of pairs."""
        shape, users, items = users.shape, users.reshape(-1), items.reshape(-1)
        if torch.is_grad_enabled():
            return self._score(users, items).view(shape)
        block = max(1, SCORE_BLOCK_BYTES // (2 * self.item_neighbors.shape[1] * self.emb_dim * 4))
        out = [self._score(users[s:s + block], items[s:s + block]) for s in range(0, users.numel(), block)]
        return torch.cat(out).view(shape) if out else self.dense_b.new_zeros(shape)

    def loss(self, batch, generator=None):
        users, pos, neg = batch["users"], batch["pos_items"], batch["neg_items"]
        loss = bpr_loss(self._score(users, pos), self._score(users, neg))
        reg = self.dense_w.square().sum().sqrt() + self.out_w.square().sum().sqrt()
        for hop in self.hop_maps:
            reg = reg + hop["w"].square().sum().sqrt()
        return loss + self.l2_lambda * reg
