"""User-facing recommender wrappers, one per model family.

Counterpart of ``beta_recsys_tpu/recommenders/__init__.py``; MF and SASRec
are ported so far.
"""

from ..convert import mf_params_from_jax, sasrec_params_from_jax
from ..core.recommender import Recommender
from ..data.sequential_data import SequentialData


class MatrixFactorization(Recommender):
    """MF with BPR: train, load, test, predict, recommend."""

    model_name = "MF"
    params_from_jax = staticmethod(mf_params_from_jax)


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
