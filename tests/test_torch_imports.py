"""The port imports with JAX, its companions, pandas and the JAX package all
blocked, and defaults to the GPU without a silent CPU fallback."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "pandas", "sklearn", "tqdm", "msgpack", "beta_recsys_tpu")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
sys.path.insert(0, {REPO!r})
import beta_recsys_tpu_torch
names = [m.name for m in pkgutil.walk_packages(beta_recsys_tpu_torch.__path__, "beta_recsys_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.ml1m_shaped_split(0, n_users=30, n_items=60, n_interactions=900, max_per_user=50, n_negative=5)
chip_smoke.rowadam_inputs(100, 40, 4, 0, "cpu", zipf=True)
chip_smoke.mf_config(0, "unused", sparse_optim=True)
chip_smoke.sasrec_config(0, "unused", num_heads=1)
chip_smoke.mesh_config(0, "unused", (1, 4))
for name in chip_smoke.NCF_FAMILY:
    chip_smoke.ncf_config(name, 0, "unused")
for name in chip_smoke.GRAPH_FAMILY:
    chip_smoke.graph_config(name, 0, "unused", max_epoch=1)
for name in chip_smoke.CAPPED_FAMILY:
    chip_smoke.capped_config(name, 0, "unused")
for name in chip_smoke.SSL_FAMILY:
    chip_smoke.ssl_config(name, 0, "unused")
chip_smoke.DrawReplay()
for name in chip_smoke.SEQ_FAMILY:
    chip_smoke.seq_config(name, 0, "unused")
from beta_recsys_tpu_torch.core.train_engine import PrefixEpochTrainer, SequenceTimeEpochTrainer, UserRowEpochTrainer
from beta_recsys_tpu_torch.models.narm import NARM, gru_scan
from beta_recsys_tpu_torch.models.tisasrec import TiSASRec, bucket_flat_index
from beta_recsys_tpu_torch.models.vaecf import VAECF, latent_noise
from beta_recsys_tpu_torch.recommenders import NARM as NARMRecommender, TiSASRec as TiSASRecRecommender, VAECF as VAECFRecommender
bucket_flat_index(chip_smoke.torch.zeros(2, 3, 3, dtype=chip_smoke.torch.long), 2, 5)
latent_noise(None, (2, 3), "cpu")
from beta_recsys_tpu_torch.ops.graph import sgl_augment, sgl_draws, undirected_pairs
edge_pair, n_pairs = undirected_pairs([0, 1], [1, 0])
sgl_augment(sgl_draws(None, n_pairs, "cpu"), chip_smoke.torch.tensor([0, 1]), chip_smoke.torch.tensor([1, 0]),
            chip_smoke.torch.as_tensor(edge_pair), 2)
from beta_recsys_tpu_torch.core.train_engine import OptaxRMSprop
from beta_recsys_tpu_torch.models.cmn import build_item_neighborhoods
from beta_recsys_tpu_torch.ops.ultragcn_prep import get_ii_constraint_mat
import scipy.sparse as sp
csr = sp.csr_matrix(chip_smoke.np.eye(4, 5, dtype=chip_smoke.np.float32))
build_item_neighborhoods(csr)
get_ii_constraint_mat(csr, 2)
OptaxRMSprop([chip_smoke.torch.zeros(2, requires_grad=True)], lr=0.1)
from beta_recsys_tpu_torch.parallel.mesh import make_mesh
from beta_recsys_tpu_torch.ops.kernels.ring_exchange import ring_allgather
make_mesh(1, 4, ["cpu"] * 4)
ring_allgather([chip_smoke.torch.zeros(8, 4) for _ in range(3)])
for name in chip_smoke.GROCERY_FAMILY:
    chip_smoke.grocery_config(name, 0, "unused")
from beta_recsys_tpu_torch.core.train_engine import TripleEpochTrainer, alias_tables
from beta_recsys_tpu_torch.data.grocery_data import GroceryData
from beta_recsys_tpu_torch.datasets.synthetic import add_synthetic_baskets
from beta_recsys_tpu_torch.models.knn import ItemKNN, UserKNN
from beta_recsys_tpu_torch.models.triple2vec import Triple2vec
from beta_recsys_tpu_torch.models.tvbr import TVBR
from beta_recsys_tpu_torch.models.vbcar import VBCAR, latent_noise as vbcar_noise
from beta_recsys_tpu_torch.ops.sampling import alias_negatives
from beta_recsys_tpu_torch.recommenders import ItemKNN as ItemKNNRecommender, Triple2vec as Triple2vecRecommender
from beta_recsys_tpu_torch.recommenders import TVBR as TVBRRecommender, UserKNN as UserKNNRecommender
from beta_recsys_tpu_torch.recommenders import VBCAR as VBCARRecommender
from beta_recsys_tpu_torch.utils.triple_sampler import Sampler
frame = dict(col_user=chip_smoke.np.array([0, 0, 1]), col_item=chip_smoke.np.array([1, 2, 0]),
             col_rating=chip_smoke.np.ones(3, chip_smoke.np.float32), col_timestamp=chip_smoke.np.array([3, 1, 2]))
frame = add_synthetic_baskets(frame, 2)
data = GroceryData((frame, frame, frame))
data.sample_triples(6, time_step=2, seed=0)
data.user_item_features(emb_dim=3)
prob, alias = alias_tables(frame["col_item"], 3, "cpu")
alias_negatives(None, (2, 3), prob, alias)
vbcar_noise(None, (2, 3), "cpu")
UserKNN(dict(), 2, 3, dict(interactions=chip_smoke.np.eye(2, 3)), device="cpu")
from beta_recsys_tpu_torch.core.eval_engine import FullCatalogEvaluator, TopKRetrievalEvaluator, write_per_user
from beta_recsys_tpu_torch.core.rating_eval import RatingEvaluator
from beta_recsys_tpu_torch.models.mf import MF
from beta_recsys_tpu_torch.ops.topk import exclusion_lists, retrieval_topk, streaming_topk
torch = chip_smoke.torch
mf = MF(dict(), 4, 5, device="cpu").init_weights(torch.Generator().manual_seed(0))
ex = exclusion_lists(csr)
retrieval_topk(torch.ones(4, 3), torch.ones(5, 3), 2, exclude_list=ex, user_chunk=2)
streaming_topk(torch.ones(4, 3), torch.ones(5, 3), 2, block=2, exclude_mask=torch.zeros(4, 5, dtype=torch.bool))
FullCatalogEvaluator(mf, [0, 1], csr, csr).evaluate()
TopKRetrievalEvaluator(mf, [0, 1], csr, csr, ks=(1, 2), mode="approx").evaluate()
RatingEvaluator(mf, dict(col_user=[0, 1], col_item=[1, 2], col_rating=[1.0, 0.0]), ("rmse", "auc")).evaluate()
chip_smoke.retrieval_bound_ms(4, 5, 3, torch.float32)
chip_smoke.same_ids("p", "w", chip_smoke.np.zeros((1, 2)), chip_smoke.np.zeros((1, 2)), None)
from beta_recsys_tpu_torch.core.eval_engine import RankingEvaluator
from beta_recsys_tpu_torch.parallel import default_param_rule, make_sharded_train_step, pad_to_multiple, shard_batch
from beta_recsys_tpu_torch.parallel import shard_params
from beta_recsys_tpu_torch.parallel.comm_analysis import collective_bytes, estimate_link_bytes
from beta_recsys_tpu_torch.parallel.data_parallel import DataParallelStep, mesh_round_batch, pointwise_prepare
for shape in ((2, 1), (1, 2)):
    mesh = make_mesh(*shape, ["cpu"] * 2)
    rule = default_param_rule(4, 5, min_rows=1)
    shard_params(dict(mf.named_parameters()), mesh, rule)
    shard_batch(dict(users=torch.arange(4)), mesh)
    step, place = make_sharded_train_step(mf, torch.optim.SGD(mf.parameters(), lr=0.1), mesh, param_rule=rule)
    batch = dict(users=torch.tensor([0, 1]), pos_items=torch.tensor([1, 2]), neg_items=torch.tensor([3, 4]))
    counts = collective_bytes(step, batch)
    estimate_link_bytes(counts, 2)
    place()
mesh_round_batch(5, mesh)
pad_to_multiple(chip_smoke.np.arange(3), 2)
pointwise_prepare(dict(u=torch.arange(2), it=torch.arange(2), neg=torch.arange(4), r=torch.ones(2)))
chip_smoke.on_mesh(chip_smoke.mf_config(0, "unused", sparse_optim=False), (2, 2))
import tempfile
from beta_recsys_tpu_torch.cli import run_experiment, serve_topk, train_model
from beta_recsys_tpu_torch.core.mixed_precision import loss_with_dtype, row_loss_with_dtype
from beta_recsys_tpu_torch.core.seq_eval_engine import SeqEvalEngine
from beta_recsys_tpu_torch.datasets import DATASET_REGISTRY, data_split, host, load_split_dataset, seq_data_utils
from beta_recsys_tpu_torch.datasets.synthetic import SyntheticStructured, generate_structured_data
from beta_recsys_tpu_torch.experiment import Experiment, expand_grid, tune
from beta_recsys_tpu_torch.utils.common import save_to_csv, write_json
from beta_recsys_tpu_torch.utils.logger import Logger
from beta_recsys_tpu_torch.utils.monitor import Monitor
batch = dict(users=torch.tensor([0, 1]), pos_items=torch.tensor([1, 2]), neg_items=torch.tensor([3, 4]))
loss_with_dtype(mf, "bfloat16")(batch).backward()
row_loss_with_dtype(mf, "bfloat16")
root = tempfile.mkdtemp()
frame = data_split.generate_random_data(300, 10, 20, seed=0)
chip_smoke.np.random.seed(0)
data_split.split_data(data_split.filter_user_item(frame, 1, 2), "leave_one_out", 0, n_negative=3,
                      save_dir=root, n_test=1)
data_split.split_data(frame, "random_basket", 0.2, n_negative=3, save_dir=root, n_test=1, use_native=False)
seq_data_utils.create_seq_db(frame)
generate_structured_data(n_users=10, n_items=30, n_interactions=100)
load_split_dataset(dict(dataset=dict(dataset="synthetic", root_dir=root, n_test=1, n_negative=5)))
expand_grid([dict(name="lr", type="range", min=0.001, max=0.1, n=3)])
SeqEvalEngine().sequential_evaluation(lambda p: torch.ones(p.shape[0], 4), [[1, 2, 3]], 3, top_n=2)
Monitor(delay=0.01).stop()
train_model.parse_args(argv=["--model", "mf", "--device", "cpu"])
from beta_recsys_tpu_torch.data.auxiliary_data import Auxiliary
from beta_recsys_tpu_torch.data.base_data import BaseData
from beta_recsys_tpu_torch.data.data_loaders import instance_bce_loader, instance_bpr_loader
from beta_recsys_tpu_torch.data.data_loaders import instance_mul_neg_loader, instance_vae_loader
from beta_recsys_tpu_torch.datasets.raw_tables import epoch_seconds
from beta_recsys_tpu_torch.utils import evaluation
from beta_recsys_tpu_torch.utils.unigram_table import UnigramTable
np = chip_smoke.np
baskets = dict(n_products=50, baskets=(2, 4), basket_size=(1, 4))
for name, shape in (("ml_100k", chip_smoke.ML100K_SHAPE), ("dunnhumby", dict(n_households=20, **baskets)),
                    ("tafeng", dict(n_users=20, **baskets))):
    chip_smoke.preprocessed(name, 0, tempfile.mkdtemp(), shape)
for name in ("amazon_beauty", "yelp", "instacart_25", "lastfm-2k"):
    DATASET_REGISTRY[name](root_dir=root)
epoch_seconds(["2014-04-07T10:51:09.277Z"])
Auxiliary(n_users=2, n_items=3).item_features(dim=4)
small = BaseData((frame, frame, frame))
for batches in (instance_bpr_loader(small, 2), instance_bce_loader(small, 2, 2), instance_vae_loader(small, 2),
                instance_mul_neg_loader(small, 2, 2)):
    list(batches)
UnigramTable([1, 2, 3]).sample(4, np.random.default_rng(0))
truth = dict(col_user=np.array([0, 0, 1]), col_item=np.array([1, 2, 0]), col_rating=np.array([1.0, 0.0, 1.0]))
pred = dict(col_user=np.array([0, 0, 1]), col_item=np.array([1, 2, 0]), col_prediction=np.array([0.9, 0.1, 0.5]))
for fn in evaluation.METRIC_FNS.values():
    fn(truth, pred)
from types import SimpleNamespace
from beta_recsys_tpu_torch.core.sparse_optim import SparseEpochTrainer
from beta_recsys_tpu_torch.utils.common import DictToObject, normalized_adj_single
for layout in ("unified", "compact", "unified_bf16"):
    trainer = SparseEpochTrainer(mf, SimpleNamespace(users=np.arange(4), items=np.arange(4)), 2, None, 0.05,
                                 torch.optim.Adam([mf.global_bias], lr=0.05), row_update=layout)
    trainer.run_batches(*(torch.tensor([[0, 1]]) for _ in range(3)))
normalized_adj_single(csr)
DictToObject(dict(a=dict(b=1)))
for bf16 in (False, True):
    chip_smoke.packed_inputs(4, 5, 2, 3, True, 0, bf16, device="cpu")
    chip_smoke.packed_bound(3, 2, 9, bf16)
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax_pandas_or_reference():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True, timeout=120, cwd=REPO
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 55  # every module was reached


def test_resolve_device_raises_without_cuda(monkeypatch):
    from beta_recsys_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_recommender_defaults_to_cuda(monkeypatch):
    from beta_recsys_tpu_torch.recommenders import SASRec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SASRec({"model": {"model": "SASRec"}})
    assert SASRec({"model": {"model": "SASRec"}}, device="cpu").device == torch.device("cpu")


def test_mf_recommender_defaults_to_cuda(monkeypatch):
    from beta_recsys_tpu_torch.recommenders import MatrixFactorization

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MatrixFactorization({"model": {"model": "MF"}})
    assert MatrixFactorization({"model": {"model": "MF"}}, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("name", ["GMFRecommender", "MLPRecommender", "NeuCF"])
def test_ncf_family_recommenders_default_to_cuda(monkeypatch, name):
    from beta_recsys_tpu_torch import recommenders

    cls = getattr(recommenders, name)
    config = {"model": {"model": cls.model_name}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(config)
    assert cls(config, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("name", ["PairwiseGMFRecommender", "CMN", "UltraGCN", "MixGCF"])
def test_multineg_and_memory_recommenders_default_to_cuda(monkeypatch, name):
    from beta_recsys_tpu_torch import recommenders

    cls = getattr(recommenders, name)
    config = {"model": {"model": cls.model_name}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(config)
    assert cls(config, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("name", ["LightGCN", "NGCF"])
def test_graph_recommenders_and_propagators_default_to_cuda(monkeypatch, name):
    from beta_recsys_tpu_torch import recommenders
    from beta_recsys_tpu_torch.ops.graph import pack_propagator

    cls = getattr(recommenders, name)
    config = {"model": {"model": cls.model_name}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(config)
    assert cls(config, device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_propagator([0], [1], [1.0], 2)
    assert pack_propagator([0], [1], [1.0], 2, device="cpu").dense.device == torch.device("cpu")


@pytest.mark.parametrize("name", ["SimGCL", "SGL", "BUIR", "LCFN"])
def test_ssl_recommenders_default_to_cuda(monkeypatch, name):
    from beta_recsys_tpu_torch import recommenders

    cls = getattr(recommenders, name)
    config = {"model": {"model": cls.model_name}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(config)
    assert cls(config, device="cpu").device == torch.device("cpu")
