"""User-facing recommender wrappers, one per model family.

Counterpart of ``beta_recsys_tpu/recommenders/__init__.py``; MF, GMF, MLP,
NeuMF, LightGCN, NGCF, PairwiseGMF, CMN, UltraGCN, MixGCF, SimGCL, SGL,
BUIR, LCFN, SASRec, TiSASRec, NARM, VAECF, Triple2vec, VBCAR, TVBR,
UserKNN and ItemKNN: every recommender of the JAX package.
"""

import numpy as np

from ..convert import (
    gmf_params_from_jax,
    knn_params_from_jax,
    lightgcn_params_from_jax,
    mf_params_from_jax,
    mlp_params_from_jax,
    ncf_params_from_jax,
    ngcf_params_from_jax,
    sasrec_params_from_jax,
    triple2vec_params_from_jax,
    tvbr_params_from_jax,
    vbcar_params_from_jax,
)
from ..core.recommender import Recommender
from ..data.grocery_data import GroceryData
from ..data.sequential_data import SequentialData
from ..models.cmn import build_item_neighborhoods
from ..ops.ultragcn_prep import get_ii_constraint_mat


class MatrixFactorization(Recommender):
    """MF with BPR: train, load, test, predict, recommend."""

    model_name = "MF"
    params_from_jax = staticmethod(mf_params_from_jax)


class GMFRecommender(Recommender):
    """GMF with BCE on sampled negatives."""

    model_name = "GMF"
    params_from_jax = staticmethod(gmf_params_from_jax)


class MLPRecommender(Recommender):
    """The MLP tower with BCE on sampled negatives."""

    model_name = "MLP"
    params_from_jax = staticmethod(mlp_params_from_jax)


class NeuCF(Recommender):
    """NeuMF, optionally warm-started from pretrained GMF and MLP params:
    the JAX package's trees (a checkpoint's ``raw["params"]``) or the
    port's (``nest_dotted(rec.model.state_dict())``). They replace the
    initial GMF tables, and the MLP tables and ``layers``, bit for bit."""

    model_name = "NCF"
    params_from_jax = staticmethod(ncf_params_from_jax)

    def __init__(self, config, gmf_params=None, mlp_params=None, device=None, mesh_devices=None):
        super().__init__(config, device, mesh_devices)
        self._pretrained = {"gmf_params": gmf_params, "mlp_params": mlp_params}

    def build_artifacts(self, data):
        return {k: v for k, v in self._pretrained.items() if v is not None}


class LightGCN(Recommender):
    """LightGCN over the normalized interaction graph. ``adj_variant`` in
    the model config picks the normalization: "sym" (the paper's, default),
    "row" or "row_selfloop" (the reference's D^-1 (A + I), the shipped
    config's); ``graph_format`` the propagation route (``ops/graph.py``).
    Serving propagates once a ``test()``, ``predict()`` or ``recommend()``."""

    model_name = "LightGCN"
    params_from_jax = staticmethod(lightgcn_params_from_jax)

    def build_artifacts(self, data):
        return {"adj": data.get_norm_adj(self.config.model.get("adj_variant", "sym"))}


class NGCF(Recommender):
    """NGCF over the row-normalized interaction graph D^-1 A."""

    model_name = "NGCF"
    params_from_jax = staticmethod(ngcf_params_from_jax)

    def build_artifacts(self, data):
        return {"adj": data.get_norm_adj("row")}


class PairwiseGMFRecommender(Recommender):
    """PairwiseGMF with BPR; its memories warm-start CMN."""

    model_name = "PairwiseGMF"


class CMN(Recommender):
    """CMN, optionally warm-started from a PairwiseGMF's memories:
    ``user_embeddings`` and ``item_embeddings`` (arrays or tensors, e.g.
    ``rec.model.user_memory`` of a trained ``PairwiseGMFRecommender``)
    become the initial ``user_memory`` and ``item_memory`` bit for bit.
    Each item attends over its training users (``build_item_neighborhoods``)."""

    model_name = "CMN"

    def __init__(self, config, user_embeddings=None, item_embeddings=None, device=None, mesh_devices=None):
        super().__init__(config, device, mesh_devices)
        self._pretrained = {"user_embeddings": user_embeddings, "item_embeddings": item_embeddings}

    def build_artifacts(self, data):
        nb, nb_len = build_item_neighborhoods(data.user_item_csr())
        return {"item_neighbors": nb, "item_nb_len": nb_len,
                **{k: v for k, v in self._pretrained.items() if v is not None}}


class UltraGCN(Recommender):
    """UltraGCN on multineg batches, with its degree vectors and item-item
    neighbours computed on the host from the train split."""

    model_name = "UltraGCN"

    def build_artifacts(self, data):
        train_mat, beta_ud, beta_id = data.create_constraint_mat()
        nb, sims = get_ii_constraint_mat(train_mat, int(self.config.model.get("ii_neighbor_num", 10)))
        return {"constraint": (beta_ud, beta_id), "ii_neighbors": nb, "ii_sims": sims}


class SymGraphRecommender(Recommender):
    """A model over the symmetric-normalized interaction graph D^-1/2 A D^-1/2."""

    def build_artifacts(self, data):
        return {"adj": data.get_norm_adj("sym")}


class MixGCF(SymGraphRecommender):
    """MixGCF on multineg batches of K * n_negs candidates a positive."""

    model_name = "MixGCF"


class SimGCL(SymGraphRecommender):
    """SimGCL; serving scores the raw tables."""

    model_name = "SimGCL"


class SGL(SymGraphRecommender):
    """SGL, its augmented views drawn on the device each step."""

    model_name = "SGL"


class BUIR(SymGraphRecommender):
    """BUIR's online and target encoders; the trainer moves the target by
    the model's ``post_update`` after every step. ``predict()`` raises
    ``NotImplementedError``, as the JAX package's does."""

    model_name = "BUIR"


class LCFN(Recommender):
    """LCFN over the hypergraph-Laplacian eigenvectors of the train split
    (``BaseData.get_graph_embeddings(cut_off)``, computed on the host once a
    data object)."""

    model_name = "LCFN"

    def build_artifacts(self, data):
        return {"graph_embeddings": data.get_graph_embeddings(float(self.config.model.get("cut_off", 0.2)))}


class SASRec(Recommender):
    """SASRec sequential recommender: train, load, test, predict, recommend.

    Training (``Recommender.train`` on a ``SequentialData``) builds each
    user's train sequence as the scoring context, so validation scores
    against it; after training the model holds the best checkpoint, and the
    final test and recommend() extend the context with the user's
    validation items (test_model()).
    """

    model_name = "SASRec"
    data_class = SequentialData
    params_from_jax = staticmethod(sasrec_params_from_jax)

    def _maxlen(self):
        return int(self.config.model.get("maxlen", 200))

    def build_artifacts(self, data):
        return {"ctx": data.eval_context(self._maxlen())}

    def test_model(self):
        test_ctx = self.data.eval_context(self._maxlen(), extra_df=self.data.valid[0])
        return self.model.with_context(test_ctx)


class TiSASRec(Recommender):
    """TiSASRec: each user's train sequence and its clipped time intervals
    are the scoring context; the final test and recommend() extend both
    with the user's validation items (``tisasrec_eval_context``)."""

    model_name = "TiSASRec"
    data_class = SequentialData

    def _spans(self):
        return int(self.config.model.get("maxlen", 50)), int(self.config.model.get("time_span", 256))

    def build_artifacts(self, data):
        ctx, ctx_time = data.tisasrec_eval_context(*self._spans())
        return {"ctx": ctx, "ctx_time": ctx_time}

    def test_model(self):
        return self.model.with_context(*self.data.tisasrec_eval_context(*self._spans(), extra_df=self.data.valid[0]))


class NARM(Recommender):
    """NARM on (prefix, target) examples; scoring encodes each user's last
    ``maxlen`` train items, and the final test and recommend() the
    train+valid context."""

    model_name = "NARM"
    data_class = SequentialData

    def _maxlen(self):
        return int(self.config.model.get("maxlen", 19))

    def build_artifacts(self, data):
        return {"ctx": data.eval_context(self._maxlen())}

    def test_model(self):
        return self.model.with_context(self.data.eval_context(self._maxlen(), extra_df=self.data.valid[0]))


class VAECF(Recommender):
    """VAE-CF over each user's binarized train row (float32 0/1)."""

    model_name = "VAECF"

    def build_artifacts(self, data):
        rows = np.asarray(data.user_item_csr().todense(), dtype=np.float32)
        return {"user_rows": (rows > 0).astype(np.float32)}


class Triple2vec(Recommender):
    """Triple2vec on the basket triples of a ``GroceryData`` (its train
    frame carries an order column)."""

    model_name = "Triple2vec"
    data_class = GroceryData
    params_from_jax = staticmethod(triple2vec_params_from_jax)


class VBCAR(Recommender):
    """VBCAR over ``GroceryData.user_item_features`` of width ``late_dim``
    (``item_fea_type`` "random": seeded normal draws)."""

    model_name = "VBCAR"
    data_class = GroceryData
    params_from_jax = staticmethod(vbcar_params_from_jax)

    def build_artifacts(self, data):
        user_fea, item_fea = data.user_item_features(
            fea_type=self.config.model.get("item_fea_type", "random"),
            emb_dim=int(self.config.model.get("late_dim", 128)),
        )
        return {"user_fea": user_fea, "item_fea": item_fea}


class TVBR(VBCAR):
    """TVBR: VBCAR's features, on time-bucketed triples (``time_step``)."""

    model_name = "TVBR"
    params_from_jax = staticmethod(tvbr_params_from_jax)


class UserKNNRecommender(Recommender):
    """UserKNN over the train interactions; ``train`` evaluates once and
    writes the epoch-0 checkpoint."""

    model_name = "UserKNN"
    params_from_jax = staticmethod(knn_params_from_jax)

    def build_artifacts(self, data):
        return {"interactions": data.user_item_csr()}


class ItemKNNRecommender(UserKNNRecommender):
    """ItemKNN over the train interactions."""

    model_name = "ItemKNN"


# The reference's class names (beta_rec/recommenders/userKNN.py, itemKNN.py).
UserKNN = UserKNNRecommender
ItemKNN = ItemKNNRecommender
