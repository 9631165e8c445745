"""BUIR: bootstrapped user-item representations (an online and a target
LightGCN encoder).

Counterpart of ``beta_recsys_tpu/models/buir.py``: two encoders over the
``sym`` adjacency (``artifacts["adj"]``), each the layer mean of its
Xavier-uniform tables and ``n_layers`` propagations; the target starts as a
copy of the online one, takes no gradient (its tables are parameters with
``requires_grad`` off, outside the optimizer) and moves only by
``post_update``, the EMA t * m + o * (1 - m) (m = ``momentum``) the trainer
calls after every optimizer step. A linear predictor (``pred_w``,
``pred_b``) maps the online side; the loss is the batch mean of 2 -
2 cos(pred(u_on), i_tgt) + 2 - 2 cos(pred(i_on), u_tgt). Scores are
pred(u_on) . i_on + u_on . pred(i_on), summed as two products; like the JAX
model it has no single factorized table pair, so ``score_pairs`` (and
``predict()``) raise ``NotImplementedError``. Parameter names follow the
JAX params tree (``online.user_emb``, ``online.item_emb``,
``target.user_emb``, ``target.item_emb``, ``pred_w``, ``pred_b``).
"""

import torch
from torch import nn

from ..ops.graph import propagate_mean
from .base import RecModel
from .lightgcn import graph_propagator, xavier_uniform_
from .simgcl import l2_rows


class BUIR(RecModel):
    batch_kind = "pairwise"

    def __init__(self, config, n_users, n_items, artifacts=None, device=None):
        super().__init__(config, n_users, n_items, artifacts, device)
        self.momentum = float(config.get("momentum", 0.995))
        self.n_layers = int(config.get("n_layers", 3))
        self.prop = graph_propagator(self, config)
        d, dev = self.emb_dim, self.device

        def encoder(trained):
            return nn.ParameterDict({
                "user_emb": nn.Parameter(torch.empty(n_users, d, device=dev), requires_grad=trained),
                "item_emb": nn.Parameter(torch.empty(n_items, d, device=dev), requires_grad=trained),
            })

        self.online = encoder(True)
        self.target = encoder(False)
        self.pred_w = nn.Parameter(torch.empty(d, d, device=dev))
        self.pred_b = nn.Parameter(torch.empty(d, device=dev))

    @torch.no_grad()
    def init_weights(self, generator):
        """Xavier-uniform online tables and predictor weight drawn from a
        CPU ``torch.Generator``, the target a copy of the online tables, a
        zero predictor bias."""
        for key in ("user_emb", "item_emb"):
            self.online[key].copy_(xavier_uniform_(torch.empty(self.online[key].shape), generator))
            self.target[key].copy_(self.online[key])
        self.pred_w.copy_(xavier_uniform_(torch.empty(self.pred_w.shape), generator))
        self.pred_b.zero_()
        return self

    def _encode(self, encoder):
        return propagate_mean(self.prop, encoder["user_emb"], encoder["item_emb"], self.n_layers)

    def _predict(self, x):
        return x @ self.pred_w + self.pred_b

    @torch.no_grad()
    def post_update(self):
        """EMA the target encoder toward the online one, in the JAX order."""
        m = self.momentum
        for key in ("user_emb", "item_emb"):
            t, o = self.target[key], self.online[key]
            t.copy_(t * m + o * (1.0 - m))

    def loss(self, batch, generator=None):
        users, items = batch["users"], batch["pos_items"]
        u_on_all, i_on_all = self._encode(self.online)
        with torch.no_grad():
            u_tg_all, i_tg_all = self._encode(self.target)
        u_on = self._predict(u_on_all[users])
        i_on = self._predict(i_on_all[items])
        loss_ui = 2 - 2 * (l2_rows(u_on) * l2_rows(i_tg_all[items])).sum(dim=-1)
        loss_iu = 2 - 2 * (l2_rows(i_on) * l2_rows(u_tg_all[users])).sum(dim=-1)
        return (loss_ui + loss_iu).mean()

    def buir_tables(self):
        """(pred(u_on), u_on, pred(i_on), i_on); inside
        ``holding_embeddings()`` computed once for every scoring call."""
        if self._held is not None and "buir" in self._held:
            return self._held["buir"]
        u_on, i_on = self._encode(self.online)
        tables = (self._predict(u_on), u_on, self._predict(i_on), i_on)
        if self._held is not None:
            self._held["buir"] = tables
        return tables

    def score_candidates(self, users, cand_items):
        u_pred, u_on, i_pred, i_on = self.buir_tables()
        s_ui = torch.einsum("ud,ucd->uc", u_pred[users], i_on[cand_items])
        s_iu = torch.einsum("ud,ucd->uc", u_on[users], i_pred[cand_items])
        return s_ui + s_iu

    def score_all(self, users):
        u_pred, u_on, i_pred, i_on = self.buir_tables()
        return u_pred[users] @ i_on.T + u_on[users] @ i_pred.T
