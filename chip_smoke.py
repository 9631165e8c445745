#!/usr/bin/env python3
"""Drive the PyTorch port (beta_recsys_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--sharded-only | --ring-only | --mesh-only | --layouts-only | --profile PHASE]

Phases, each printed with the seconds elapsed:
  0. environment: the card (nvidia-smi), torch and CUDA versions, TF32 flags;
  1. build the port's CUDA kernels from csrc/ (one nvcc call each, all
     started together);
  2. each kernel against its plain PyTorch version on the card, at the shapes
     its paths give it (fused_rowadam one table a launch, the MF step's two
     tables in one grouped launch, and a table-scale shape; the flash
     forward and backward at head dims 16, 32 and 64, dropout rates 0 and
     0.1, float32 and bfloat16, T up to 200 with the backward's 64-row tile
     edges, their dropout masks bit for bit), with times (kernel, plain, one
     library call as a yardstick; the backward also queued behind a sleep
     kernel, its time on the device) and the least time the card could take;
  3. train MF + BPR (configs/mf_default.json, lazy Adam, row_update "fused")
     on the structured synthetic split through MatrixFactorization(cfg)
     .train(data), capped at MF_SPARSE_EPOCHS: 1 fused_rowadam launch a
     step, best valid and test ndcg@10 inside the JAX package's band at
     that cap; then test() and recommend();
  4. train MF with the dense trainer (mf_default.json, capped at
     MF_DENSE_EPOCHS): test ndcg@10 inside the JAX package's band;
  5. serve the JAX-trained MF checkpoint: test() gives the JAX metrics;
  6. serve the trained SASRec checkpoint in parity_runs/: load -> test() ->
     predict() -> recommend(); the test metrics must reproduce the JAX
     package's to 1e-4 and the top-10 lists must match the plain path;
  7. serve configs/sasrec_default.json (maxlen 200) with weights from the
     port's initializer over synthetic data shaped like MovieLens-1M;
  8. train SASRec at the trained checkpoint's config through SASRec(cfg)
     .train(data) on the structured split to early stop: the flash backward
     once per block a step, best valid and test ndcg@10 inside the JAX
     package's band; its first SASREC_REPEAT_EPOCHS epochs twice more, the
     two runs' parameters bit-identical; then test(), predict() and
     recommend() against the plain path, and one profiled epoch;
  9. 20 training steps at configs/sasrec_default.json's shapes (maxlen 200,
     lr 0.5) over the MovieLens-1M-shaped data: finite loss, exact launches;
 10. short trainings at head dims 16 (emb 32, 2 heads) and 64 (1 head);
 11. the ring all-gather against its plain version, bit for bit, with every
     rank on cuda:0 (loopback: the copy kernel): n 2/3/4/8 x C 8/200/400/
     800/8192 x d 64, 100 calls back to back each, with times and the device
     time each rank adds;
 12. on 4 cards or more (with --chips 4): `nvidia-smi topo -m`, peer access,
     and phase 11 across cuda:0-3 against torch.cuda.nccl.all_gather;
 13. the slice's main path: MatrixFactorization(cfg, mesh_devices=["cuda:0"]
     * 4).train(data) on a (1, 4) mesh, lazy Adam, ring lookup, 1 epoch
     (ONE_CARD_MESH_EPOCHS), bit-equal to the one-device lazy-Adam trainer,
     exact ring launches, no bucket overflow; then test() and recommend()
     (no pad item); on 4 cards again on cuda:0-3, 3 epochs;
 14. 1 epoch on a (2, 2) mesh through run_batches against the one-device
     trainer, within MESH_TOL (on 4 cards again on cuda:0-3, 3 epochs);
 15. 20 steps on a (1, 4) mesh of cuda:0 with 1,000,000-row tables and
     batches of 16,384: time a step and the ring's share of device time;
 16. on 4 cards: the slice trained to early stop on cuda:0-3, inside the JAX
     package's lazy-Adam band;
 17. serve the JAX-trained GMF, MLP and NCF checkpoints: load -> test() ->
     predict() -> recommend(k=10); test() reproduces the JAX package's
     metrics to 1e-4, the top-10 lists match the same model served by the
     port on the CPU; users/s of test() and recommend();
 18. train GMF, MLP and NCF at their shipped configs (BCE on 4 sampled
     negatives a positive, batch 400, Adam at lr 1e-3) on the structured
     split through XRecommender(cfg).train(data), seed 0, capped at
     NCF_EPOCHS: best valid and test ndcg@10 inside the JAX package's
     ten-seed bands at that cap,
     NCF's first epoch twice, bit for bit; examples/s and a profiled
     window each (an epoch's batch forming and 10 steps);
 19. NCF warm-started from phase 18's MLP and a GMF trained as in phase 18
     at NCF's width (emb 8; the shipped GMF is 64 wide) for
     GMF_PRETRAIN_EPOCHS epochs, for NCF_WARM_EPOCHS epochs (neither holds a
     band): NCF starts from
     their tables and layers bit for bit; its metrics are printed. Phases
     17-19 launch none of the kernels (every count read 0 around each);
 20. serve the JAX-trained seed-0 LightGCN and NGCF checkpoints: load ->
     test() -> predict() -> recommend(k=10); test() reproduces the JAX
     package's metrics to 1e-4, predict() the port's on the CPU to 1e-6, the
     top-10 lists match the CPU's; LightGCN's test() once more through the
     sparse (CSR) route, within 1e-5 of the dense route's, and whether that
     route's products repeat bit for bit; users/s of test() and recommend();
 21. train LightGCN at its shipped config (edge keep 0.6, batch 1,024, Adam
     at lr 2.5e-4) through LightGCN(cfg).train(data), seed 0, to early stop:
     best valid and test ndcg@10 inside the JAX package's ten-seed bands;
     its first epoch twice, bit for bit; positives/s;
 22. the same for NGCF (message dropout 0.1, lr 0.01), without the repeat.
     Phases 20-22 launch none of the kernels and are profiled
     (``--profile graph-models``: a test() and a recommend() of each
     checkpoint; an epoch's batch forming and 3 steps of each model after
     2 to warm up), printing a WARNING where the profiler recorded no CUDA
     events;
 23. serve the JAX-trained seed-0 UltraGCN checkpoint: load -> test() ->
     predict() -> recommend(k=10); test() reproduces the JAX package's
     metrics to 1e-4, predict() the port's on the CPU to 1e-6, the top-10
     lists equal the CPU's for every user; users/s of test() and
     recommend();
 24. train UltraGCN (multineg batches of 50 negatives, 10 epochs) and MixGCF
     (16 candidates mixed into one negative, edge and message dropout, 5
     epochs) at their shipped configs through XRecommender(cfg).train(data),
     seed 0: best valid and test ndcg@10 inside the JAX package's ten-seed
     bands at the same caps; UltraGCN's first epoch twice, bit for bit;
 25. train PairwiseGMF (5 epochs), then CMN (rmsprop, 3 epochs)
     warm-started from its memories, at their shipped configs: both inside
     the JAX bands at those caps (each JAX seed's CMN starts from that
     seed's PairwiseGMF); CMN starts from the memories bit for bit, its
     first 5 steps equal the same steps through the port on the CPU (1e-5:
     the loss, every parameter, rmsprop's nu), its first epoch twice bit
     for bit, and the peak device memory of its test() (scored in blocks of
     pairs). Phases 23-25 launch none of the kernels and are profiled
     (``--profile capped-models``: UltraGCN's test() and
     recommend(), an epoch's batch forming and 3 steps of each model after
     2 to warm up, and CMN's test()); positives/s of every training;
 26. SimGCL and SGL (both_side InfoNCE over two views of edge dropout a
     step, drawn on the device), 27. BUIR (online and target encoders, the
     target moved by its ``post_update`` EMA after every step) and LCFN
     (hypergraph spectral filters; its eigendecomposition on the host,
     timed): each at its shipped config (emb 64, batch 1,024, Adam at lr
     1e-3) through XRecommender(cfg).train(data), seed 0, capped at
     SSL_FAMILY's epochs, against the JAX package's ten-seed bands at those
     caps (held for BUIR; reported for SimGCL, SGL and LCFN, whose bands
     reach below UNTRAINED_NDCG and so cannot fail an untrained model);
     before that, each model's first 5 steps from its initial weights on
     the card against the same steps through the port on the CPU, with the
     same batches and draws (1e-5: the loss, every parameter but Adam's
     eps-set elements, Adam's moments) and the dense A's built a step;
     BUIR's target after one step equal to m * initial + (1 - m) * online
     (1e-7), its predict() raising as the JAX package's; SGL's and BUIR's first epoch twice, bit for
     bit; LCFN's P and Q from a second eigendecomposition on a fresh data
     object bit for bit. Phases 26-27 launch none of the kernels and are
     profiled (``--profile ssl-models``: an epoch's
     batch forming and 3 steps of each model after 2 to warm up);
     positives/s of every training;
 28. TiSASRec at its shipped config (emb 64, 2 blocks, maxlen 50, time_span
     256, dropout 0.2, batch 128) through TiSASRec(cfg).train(data) on the
     structured split, seed 0, capped at SEQ_FAMILY's epochs: its first 5
     steps from the initial weights on the card against the same steps
     through the port on the CPU with the same batches, dropout masks and
     FFN ReLU decisions (1e-5: the loss, every parameter but Adam's eps-set
     elements, Adam's moments), its JAX ten-seed band reported (it reaches
     below UNTRAINED_NDCG), its first 2 epochs twice bit for bit, and
     test(), predict() and recommend(k=10) of the trained model against the
     same checkpoint served by the port on the CPU (metrics 1e-5, predict()
     1e-6 relative to max(1, |score|), the top-10 lists); sequences/s,
     test()'s peak device memory;
 29. NARM at its shipped config (emb 50, hidden 100, maxlen 19, batch 512)
     the same way without the steps: its band held, its first epoch
     twice bit for bit; examples/s;
 30. serve the JAX-trained seed-0 VAECF checkpoint: load -> test() ->
     predict() -> recommend(k=10), test() reproducing the JAX package's
     metrics to 1e-4 and the port's on the CPU; then VAECF (z 10, encoder
     [20], mult) trained to early stop inside its band, its first 2 epochs
     twice bit for bit;
 31. serve the JAX-trained seed-0 Triple2vec checkpoint on the structured
     split with synthetic baskets (five of a user's train interactions a
     basket): load -> test() -> predict() -> recommend(k=10), test()
     reproducing the JAX package's metrics to 1e-6 and the port's on the
     CPU; UserKNN and ItemKNN (batch kind "none": train() evaluates once)
     at neighbourhood 50, test() reproducing the JAX package's metrics to
     1e-6, recommend(k=10) well-formed, predict() raising as the JAX
     package's;
 32. Triple2vec at its shipped config (emb 64, 100,000 basket triples drawn
     from the seed, 5 negatives of each kind a triple, items' negatives by
     their train frequencies through an alias table, batch 512, Adam at lr
     5e-4) through Triple2vec(cfg).train(data), seed 0, capped at
     GROCERY_FAMILY's epochs: best valid and test ndcg@10 inside the JAX
     package's ten-seed bands at that cap, its first epoch twice bit for
     bit, the trained model served as the port serves it on the CPU;
 33. VBCAR (variational encoders over seeded random features, six latent
     samples a step; 5 epochs) and TVBR (VBCAR conditioned on 4 time
     buckets; 5 epochs) the same way, each held by its band (or, where the
     band's lower edge lies below UNTRAINED_NDCG, by its first 5 steps
     against the CPU's).
     Phases 28-33 launch none of the kernels and are profiled
     (``--profile seq-models grocery-models``: an epoch's batch forming
     and 3 steps of each model after 2 to warm up, as for phases
     32-33; the Triple2vec checkpoint's test() and recommend(), each KNN's
     test()); triples/s.
     The profiles of phases 20-33 run in one child process after phase 33
     (``--profile graph-models capped-models ssl-models seq-models
     grocery-models``);
 34. the serving surface on the JAX-trained MF, LightGCN and SASRec
     checkpoints: recommend(k=10) through each route it takes (MF and
     LightGCN: the streaming route with train items excluded, as the JAX
     package routes this split, and the fast route in modes exact and
     approx with float32 and bfloat16 scores; SASRec: score_all through the
     flash forward kernel) against the same checkpoint served by the port
     on the CPU (float32: equal ids, scores to 1e-6 relative to max(1,
     |score|); bfloat16: the overlap of the ids, reported);
     FullCatalogEvaluator (and TopKRetrievalEvaluator, exact and approx,
     for MF and LightGCN) giving the JAX package's metrics to 1e-6 and
     agreeing with each other; export_embeddings() round-tripped and
     against the CPU's; use_best True, False, True on a recommender whose
     engine holds the JAX MF run's last/, serving best, final, best; and
     test() with save_mode "per_user" writing the CPU's file; users/s of
     each route and evaluator;
 35. retrieval at bench.py's bench_retrieval_scale shape (10,240 users x
     162,000 items, MF tables from the initializer, k 10, 20 excluded ids a
     user): exact float32 retrieval_topk gives a full sort's ids on the CPU
     for the first 256 users, streaming_topk (item_block 8192) exact's ids,
     the bfloat16 scores a top-10 recall >= 0.95 against exact; users/s of
     each route beside its bound, the peak device memory, and the top-k
     route against a full stable sort;
 36. full-state resume: MF with lazy Adam (fused_rowadam, one launch a
     step) and with the dense trainer, 1 epoch (RESUME_EPOCHS) and then
     resume_training from last/ for 1 more, equal to 2 straight epochs bit
     for bit
     (parameters, moments, step, generator, bookkeeper); the JAX MF run's
     last/ (epoch 33, 20 epochs without a gain) resumed with the file's
     state, stopping after one epoch as the JAX engine does;
 37. the dense mesh path on ["cuda:0"] * 4 (and again on cuda:0-3 with 4
     cards): SASRec at the checkpoint's config through SASRec(cfg,
     mesh_devices).train(data) on a (4, 1) mesh, 2 epochs at dropout 0
     (each data shard's flash forward and backward; trained twice, bit for
     bit), within MESH_TOL of the same (4, 1) run on the CPU on the
     same batches, one all-reduce a step of the parameters' bytes, its
     first 5 steps at the shipped dropout equal to the CPU's with the same
     draws (1e-5), and 2 epochs on a (2, 2) mesh against the one-device
     trainer; MF on the dense path on a (2, 2) mesh (item_emb row-sharded,
     the ring all-gather once a step) against the one-device dense
     trainer; NCF on a (4, 1) mesh against the CPU's; the mesh's ranking
     and full-catalog evaluators against one device's (1e-6) for MF and
     SASRec; 1 + 1 resumed epochs equal to 2 straight, bit for bit, on the
     (1, 4) ring-lookup sparse mesh and the (2, 2) dense mesh;
 38. mixed precision, the offline pipeline and the run layer: the flash
     forward and backward in bfloat16 at the checkpoint config's training
     shape against their plain versions, with times; SASRec at the
     checkpoint's config with model.compute_dtype "bfloat16" (its forward
     and backward through the kernels in bfloat16): its first 5 steps
     against the same steps through the port on the CPU in bfloat16 (2e-2),
     2 epochs' sequences/s beside phase 8's float32 rate, and test() of the
     trained model against the CPU's (1e-3); MF with lazy Adam in bfloat16
     (fused_rowadam under bfloat16 rows, float32 gradients), MF_BF16_EPOCHS
     epochs, seed 0 inside the JAX package's bfloat16 band at that cap,
     examples/s beside phase 3's; the host library built by g++ and the
     structured interactions and leave_one_out split regenerated equal to
     the committed files; the train_model CLI on cuda in a subprocess and
     mf_default.json's two-trial grid through model.tune;
 39. the raw-file adapters behind the shipped configs, from files written
     at their datasets' published shapes from the seed (no download): an
     ml-100k u.data (943 users, 1,682 items, 100,000 ratings, >= 20 a user,
     zipf items), u.item (latin-1) and u.user in raw/ml-100k/, through
     load_split_dataset(configs/mf_default.json) (preprocess, k-core,
     leave_one_out with 10 copies of 100 negatives), make_fea_vec, and
     MatrixFactorization(cfg).train() for RAW_MF_EPOCHS epochs on lazy Adam
     (sparse_optim true: fused_rowadam once a step) and test(), ndcg@10
     above random ranking (RANDOM_NDCG); then the dunnhumby (2,500
     households) and Ta-Feng files through their shipped configs' splits
     (leave_one_basket, leave_one_out) on the host. Each preprocess runs
     twice in fresh directories and must write the same bytes; the phase
     prints the seconds to preprocess and to split, the rows before and
     after the k-core, examples/s and the launches;
 40. the lazy-Adam trainer's packed row layouts: fused_rowadam_packed and
     fused_rowadam_packed_bf16 bit for bit against their plain versions at
     MF's step (943 and 1,682 rows of emb 64 and a bias, mf_default.json's
     B 400, so L 1,200) and at table scale (1,000,000 users and 100,000
     items, B 16,384, zipf ids), with times (a call, the device's, the plain
     version, one torch.optim.SparseAdam step) and two bounds (every id's
     gradient row read, and the bytes of a write that reads no duplicate's
     row) with the device time's share of each, and the float32 one again
     after "compact"'s cut at MF's step to its default capacity and to
     capacity 16, and at table scale to PACKED_SCALE_CAPACITY, and both
     at table scale with uniform ids (PACKED_SCALE_UNIFORM: ~44,000
     distinct ids, ~10 first occurrences a warp of the kernel's grid);
     mf_default.json (sparse_optim
     true) under "unified", "compact" and "unified_bf16" at
     MF_SPARSE_EPOCHS: one packed launch a step, best valid and test
     ndcg@10 inside the JAX band of the layout, examples/s beside phase
     3's; "compact" at its default capacity dropping JAX's count, and at
     capacity 16 dropping rows, counted and warned once an epoch; the
     optimizer state's bytes of both forms at table scale (the memory held
     while packed, the peak of the packing) and their ratio;
 41. a JSON line of every kernel with its launches on each path, counted
     from 0 around that path's own calls.
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before it. With --sharded-only it builds the ring kernel alone and runs
phases 11-16, on 4 cards without the one-card trainings of 13-15 (the
4-card call's); with --ring-only, phases 11-12 and no result line (it
drives no path); with --mesh-only, the four kernels built and phase 37
alone, with no result line; with --layouts-only, the rowadam kernels built and
phases 3 and 40 alone, with no result line; with --profile <phase> ...,
only those phases' profiles and no result line. Imports nothing of JAX or of the JAX package.
"""

import argparse
import collections
import contextlib
import copy
import csv
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from beta_recsys_tpu_torch.config import load_config  # noqa: E402
from beta_recsys_tpu_torch.convert import (  # noqa: E402
    flatten_params,
    lightgcn_params_from_jax,
    ncf_params_from_jax,
    nest_dotted,
    sasrec_params_from_jax,
)
from beta_recsys_tpu_torch.core.checkpoint import load_metadata, load_raw_checkpoint  # noqa: E402
from beta_recsys_tpu_torch.core.eval_engine import (  # noqa: E402
    FullCatalogEvaluator,
    RankingEvaluator,
    TopKRetrievalEvaluator,
)
from beta_recsys_tpu_torch.core.recommender import recommend_route  # noqa: E402
from beta_recsys_tpu_torch.core.sparse_optim import (  # noqa: E402
    PackedRows,
    ShardedSparseEpochTrainer,
    SparseEpochTrainer,
    _segment_dedup,
    compact_rows,
)
from beta_recsys_tpu_torch.core.train_engine import (  # noqa: E402
    SequenceEpochTrainer,
    TrainEngine,
    make_negative_sampler,
    make_optimizer,
)
from beta_recsys_tpu_torch.data.base_data import BaseData  # noqa: E402
from beta_recsys_tpu_torch.data.grocery_data import GroceryData  # noqa: E402
from beta_recsys_tpu_torch.data.sequential_data import SequentialData  # noqa: E402
from beta_recsys_tpu_torch.datasets import build_dataset, host, load_split_dataset  # noqa: E402
from beta_recsys_tpu_torch.datasets.data_split import load_split_data  # noqa: E402
from beta_recsys_tpu_torch.datasets.synthetic import (  # noqa: E402
    SyntheticStructured,
    add_synthetic_baskets,
    generate_structured_data,
)
from beta_recsys_tpu_torch.device import fp32_matmuls  # noqa: E402
from beta_recsys_tpu_torch.utils.common import get_dataframe_from_npz  # noqa: E402
from beta_recsys_tpu_torch.ops.graph import edge_dropout  # noqa: E402
from beta_recsys_tpu_torch.ops.topk import (  # noqa: E402
    NEG_INF,
    exclusion_lists,
    retrieval_topk,
    streaming_topk,
    topk_lowest_index,
)
from beta_recsys_tpu_torch.ops.kernels import _build  # noqa: E402
from beta_recsys_tpu_torch.models import build_model  # noqa: E402
from beta_recsys_tpu_torch.models import sgl as sgl_model  # noqa: E402
from beta_recsys_tpu_torch.models import simgcl as simgcl_model  # noqa: E402
from beta_recsys_tpu_torch.models import vaecf as vaecf_model  # noqa: E402
from beta_recsys_tpu_torch.models import vbcar as vbcar_model  # noqa: E402
from beta_recsys_tpu_torch.ops import attention as port_attention  # noqa: E402
from beta_recsys_tpu_torch.ops import activations as port_activations  # noqa: E402
from beta_recsys_tpu_torch.ops.kernels import flash_attention as flash_attention_module  # noqa: E402
from beta_recsys_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    flash_causal_attention,
    flash_causal_attention_bwd,
    flash_causal_attention_bwd_reference,
    flash_causal_attention_reference,
)
from beta_recsys_tpu_torch.ops.kernels.philox import dropout_keep_mask  # noqa: E402
from beta_recsys_tpu_torch.ops.kernels.ring_exchange import ring_allgather, ring_allgather_reference  # noqa: E402
from beta_recsys_tpu_torch.ops.kernels.rowadam import (  # noqa: E402
    RowAdamPacked,
    bias_corrections,
    bias_denominators,
    fused_rowadam,
    fused_rowadam_packed,
    fused_rowadam_packed_bf16,
    fused_rowadam_packed_bf16_reference,
    fused_rowadam_packed_reference,
    fused_rowadam_reference,
    packed_touched,
)
from beta_recsys_tpu_torch.parallel.collectives import recording  # noqa: E402
from beta_recsys_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from beta_recsys_tpu_torch.models.mf import MF  # noqa: E402
from beta_recsys_tpu_torch.models.ncf import NeuMF  # noqa: E402
from beta_recsys_tpu_torch.recommenders import (  # noqa: E402
    BUIR,
    CMN,
    LCFN,
    NARM,
    NGCF,
    SGL,
    TVBR,
    VAECF,
    VBCAR,
    GMFRecommender,
    ItemKNN,
    LightGCN,
    MatrixFactorization,
    MixGCF,
    MLPRecommender,
    NeuCF,
    PairwiseGMFRecommender,
    SASRec,
    SimGCL,
    TiSASRec,
    Triple2vec,
    UltraGCN,
    UserKNN,
)
from beta_recsys_tpu_torch.utils.constants import (  # noqa: E402
    DEFAULT_ITEM_COL,
    DEFAULT_PREDICTION_COL,
    DEFAULT_RATING_COL,
    DEFAULT_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)

CHECKPOINT = os.path.join(REPO, "parity_runs/checkpoints/SASRec_default_20260821_081415_yybcvt")
SPLIT = os.path.join(
    REPO, "parity_runs/datasets/synthetic_structured/processed/leave_one_out/full_n_neg_100"
)
DEFAULT_CONFIG = os.path.join(REPO, "configs/sasrec_default.json")
MF_CONFIG = os.path.join(REPO, "configs/mf_default.json")
MF_CHECKPOINT = os.path.join(REPO, "parity_runs/checkpoints/MF_default_20260821_134231_aaquvl")

# The JAX package's SASRec(...).load(CHECKPOINT, data).test() on this split.
EXPECTED_METRICS = {
    "ndcg@10": 0.186726, "recall@10": 0.458112, "precision@10": 0.045811, "map@10": 0.106825,
}
METRIC_TOL = 1e-4  # the expected values are given to 6 decimals
# The JAX package's MatrixFactorization(...).load(MF_CHECKPOINT, data).test().
EXPECTED_MF_METRICS = {
    "ndcg@10": 0.189677, "recall@10": 0.411453, "precision@10": 0.041145, "map@10": 0.123563,
}
# (mean, std) of ndcg@10 over seeds of the JAX package's MF training on the
# same split; a port run must land within mean +- 3 std. Lazy Adam, seeds
# 0-9: `JAX_PLATFORMS=cpu python port_tools/jax_mf_band.py` (sparse_optim
# true, row_update "xla", the arithmetic of "fused"; sample std). Three
# seeds are too few for this spread: the JAX package's own seeds 3 and 6
# (test 0.1887, 0.1834) fall outside the band of seeds 0-2 (0.1719 +- 3 x
# 0.0036). Dense, seeds 0-2: PARITY_RESULTS.md, MF row.
SPARSE_BAND = {"valid": (0.20631387680768967, 0.002780269790554314),
               "test": (0.1743064731359482, 0.0070542290529480465)}
# Phase 3 (and phase 40's three layouts) run MF_SPARSE_EPOCHS epochs (the
# JAX seeds' best epochs are 12-44 of 33-65 run to early stop), against the
# same seeds read at that cap (5 since phase 40 came: the band at 10 was
# (0.195779 +- 0.002910, 0.173439 +- 0.007819)).
MF_SPARSE_EPOCHS = 5
SPARSE_BAND_AT_CAP = {"valid": (0.19002994596958162, 0.004537321237357515),
                      "test": (0.16690947562456132, 0.007891634064334789)}
DENSE_BAND = {"test": (0.1893, 0.0097)}
# Phase 4's dense trainer stops at MF_DENSE_EPOCHS: seed 0's run to early
# stop had its best epoch at 14 of 35, so the capped run's best, and its
# test(), are that run's, held to DENSE_BAND.
MF_DENSE_EPOCHS = 15
# (mean, std) of SASRec's best valid and test ndcg@10 over seeds 0-9 of the
# JAX package's training at the trained checkpoint's config on the same
# split: `JAX_PLATFORMS=cpu python port_tools/jax_sasrec_band.py` (sample
# std). The three TPU seeds of PARITY_RESULTS.md (test 0.1862 +- 0.0018)
# under-state the spread: the JAX package's own seeds 5 and 6 (test
# 0.197396, 0.197077) fall outside mean +- 3 std of that band.
SASREC_BAND = {"valid": (0.20811834037303925, 0.004043200216505683),
               "test": (0.1901898756623268, 0.00438203838237327)}
SASREC_REPEAT_EPOCHS = 10  # phase 8: the first epochs of the training, run twice more, bit for bit
# fused_rowadam against its plain version, as tests/test_rowadam_kernel.py
# holds the JAX kernel: the same float32 operations, each rounded on its own
# in both (max_abs_err 0 expected; the tolerance is the JAX kernel test's).
# Untouched rows must be bit-identical.
ROWADAM_RTOL, ROWADAM_ATOL = 1e-5, 1e-6
# Kernel against plain version, same inputs on the card. float32: the two sum
# in other orders and the kernel exponentiates in base 2, a few ulp apart.
# bfloat16: both compute in float32 and round the output once to bfloat16, so
# they may land one bfloat16 step apart (2^-7 relative): |d| <= 2e-2 * max(1, |plain|).
# lse stays float32 on both sides whatever the input type: the float32 limit.
TOL = {torch.float32: {"out": 1e-4, "lse": 1e-5}, torch.bfloat16: {"out": 2e-2, "lse": 1e-5}}
# Backward kernel against the plain backward (autograd through the plain
# forward with the same mask), same inputs on the card, |d| <= limit *
# max(1, |plain|). float32: sums of up to T products of size up to ~sqrt(dh)
# in other orders, exponents in base 2. bfloat16: both compute in float32
# and round each gradient once to bfloat16, one bfloat16 step (2^-8
# relative) apart at most.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Phase 9's mean loss over 20 steps at the shipped config through the
# kernels against the plain attention, the same seed and masks. Adam at lr
# 0.5 moves every weight by ~0.5 a step whatever its gradient's size, so
# float32 roundings part the two runs: over these steps the kernels' plain
# versions (recomputing P from lse) come 0.8% above plain autograd in mean
# loss, the kernels 1.2% (port_tools/shipped_steps.py on an H100). Backward
# forms that left a rounding of lse in P's exponent came 25% and 73% above.
SHIPPED_LOSS_TOL = 0.05
DROPOUT_RATE = 0.1  # SASRec's training dropout in every shipped config
NEAR_TIE = 1e-5  # top-10 lists may differ only where plain scores are this close
USER_BLOCK = 4096  # users per scoring call in the default config's recommend()
# H100 SXM peaks (NVIDIA data sheet): bytes/s of HBM3, FLOP/s by input type,
# NVLink bytes/s to another card each way.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
NVLINK_BYTES_PER_S = 450e9
# All-gather kernel checks: ranks x bucket rows (d 64). 200 and 400 are the MF
# path's user and item buckets at capacity_factor 2 (400 and 800 at
# MESH_CAPACITY_FACTOR); 8192 the table-scale user bucket.
RING_NS = (2, 3, 4, 8)
RING_CS = (8, 200, 400, 800, 8192)
# The sharded runs held against the one-device trainer use capacity_factor 4:
# a ring bucket holds batch positions, and on the structured split the first
# quarter of the users owns up to 252 of a batch's 400 positions, beyond the
# 200 that the default factor 2 gives (lookup_overflow counts the positions
# served as zero rows there, as the JAX package serves them). At 4 no bucket
# can overflow, so the mesh computes the one-device trainer's function.
MESH_CAPACITY_FACTOR = 4.0
# Sharded trainer on a (2, 2) mesh against the one-device trainer, same
# batches, same well-conditioned weights: the largest relative |d| of any
# parameter (over max(1, |x|)) or moment (over the table's largest moment)
# after epochs 1, 2 and 3. The data axis adds two half-batch means and sums
# a row's duplicates within each data shard first: float32 reassociation that
# Adam's m / (sqrt(v) + eps) at lr 0.05 amplifies about 8x an epoch (on the
# CPU: 1.2e-5, 1.5e-4, 9.8e-4 for parameters, 1.0e-5, 1.3e-4, 1.2e-3 for
# moments). Each epoch's loss to 1e-5 relative.
MESH_TOL = (1e-4, 1e-3, 1e-2)
ONE_CARD_MESH_EPOCHS = 1  # phases 13-14 on cuda:0 (the 4-card call's run 3 epochs)
PROFILED_STEPS = 3  # sharded steps under torch.profiler (~2,500 device activities each)
PROFILED_WINDOW = 10  # one-device training steps under torch.profiler
# The NCF family: each model's recommender, shipped config and JAX-trained
# seed-0 checkpoint.
NCF_FAMILY = {
    "GMF": (GMFRecommender, "configs/gmf_default.json", "GMF_default_20260821_134755_yybcvt"),
    "MLP": (MLPRecommender, "configs/mlp_default.json", "MLP_default_20260821_134859_yybcvt"),
    "NCF": (NeuCF, "configs/ncf_default.json", "NCF_default_20260821_134325_yybcvt"),
}
# The JAX package's XRecommender(...).load(checkpoint, data).test() on the
# structured split (tests/test_torch_serving_ncf.py holds the same values).
EXPECTED_NCF_METRICS = {
    "GMF": {"ndcg@10": 0.118532, "recall@10": 0.316013, "precision@10": 0.031601, "map@10": 0.061091},
    "MLP": {"ndcg@10": 0.135927, "recall@10": 0.335101, "precision@10": 0.033510, "map@10": 0.078096},
    "NCF": {"ndcg@10": 0.126206, "recall@10": 0.340403, "precision@10": 0.034040, "map@10": 0.064365},
}
# (mean, sample std) of best valid and test ndcg@10 over seeds 0-9 of the JAX
# package's training at each shipped config on the structured split, read at
# NCF_EPOCHS (the runs' best epochs are 4-25, early stop at 25-46):
# `JAX_PLATFORMS=cpu python port_tools/jax_ncf_band.py` (its cap_8). A port
# run must land within mean +- 3 std.
NCF_EPOCHS = 8  # phase 18's trainings
NCF_BANDS = {
    "GMF": {"valid": (0.13045619130134584, 0.002510772851312543),
            "test": (0.11243038028478622, 0.002348930295045312)},
    "MLP": {"valid": (0.15071403980255127, 0.010103409779784685),
            "test": (0.12852610722184182, 0.006717674780871493)},
    "NCF": {"valid": (0.1467988207936287, 0.008318218752347563),
            "test": (0.1256631463766098, 0.0073006308734946375)},
}
GMF_PRETRAIN_EPOCHS = 2  # phase 19's GMF at NCF's width
NCF_WARM_EPOCHS = 1  # phase 19's warm-started NeuMF
# The graph models: each recommender, shipped config and JAX-trained seed-0
# checkpoint.
GRAPH_FAMILY = {
    "LightGCN": (LightGCN, "configs/lightgcn_default.json", "lightgcn_default_20260821_134437_yybcvt"),
    "NGCF": (NGCF, "configs/ngcf_default.json", "ngcf_default_20260821_135007_yybcvt"),
}
# The JAX package's XRecommender(...).load(checkpoint, data).test() on the
# structured split (tests/test_torch_serving_graph.py holds the same values).
EXPECTED_GRAPH_METRICS = {
    "LightGCN": {"ndcg@10": 0.286911, "recall@10": 0.603393, "precision@10": 0.060339, "map@10": 0.192452},
    "NGCF": {"ndcg@10": 0.256701, "recall@10": 0.568399, "precision@10": 0.056840, "map@10": 0.164256},
}
# (mean, sample std) of best valid and test ndcg@10 over seeds 0-9 of the JAX
# package's training at each shipped config on the structured split:
# `JAX_PLATFORMS=cpu python port_tools/jax_graph_band.py`. A port run must land
# within mean +- 3 std.
GRAPH_BANDS = {
    "LightGCN": {"valid": (0.28174264132976534, 0.0015398403052019594),
                 "test": (0.28902767300605775, 0.005579727805581206)},
    "NGCF": {"valid": (0.2763703644275665, 0.005394374480066781),
             "test": (0.2530310615897179, 0.011056671663278428)},
}
SPARSE_ROUTE_TOL = 1e-5  # test() through the CSR route against the dense route's
PREDICT_TOL = 1e-6  # served scores on the card against the port's on the CPU
REPEAT_EPOCHS = 1  # NCF's, LightGCN's and UltraGCN's epochs trained twice, bit for bit
# The multineg models and the memory network: each recommender, shipped
# config and the epochs its training runs (the cap its JAX band is read at).
CAPPED_FAMILY = {
    "UltraGCN": (UltraGCN, "configs/ultragcn_default.json", 10),
    "MixGCF": (MixGCF, "configs/mixgcf_default.json", 5),
    "PairwiseGMF": (PairwiseGMFRecommender, "configs/pairwise_gmf_default.json", 5),
    "CMN": (CMN, "configs/cmn_default.json", 3),
}
ULTRAGCN_CHECKPOINT = "UltraGCN_default_20260821_135306_yybcvt"
# The JAX package's UltraGCN(...).load(checkpoint, data).test() on the
# structured split (tests/test_torch_serving_ultragcn.py holds the same values).
EXPECTED_ULTRAGCN_METRICS = {"ndcg@10": 0.037329, "recall@10": 0.080594, "precision@10": 0.008059,
                             "map@10": 0.024440}
# (mean, sample std) of best valid and test ndcg@10 over seeds 0-9 of the JAX
# package's training at each shipped config on the structured split, capped
# at CAPPED_FAMILY's epochs, CMN warm-started from that seed's PairwiseGMF:
# `JAX_PLATFORMS=cpu python port_tools/jax_ultragcn_band.py` and
# `port_tools/jax_cmn_band.py`. A port run must land within mean +- 3 std.
CAPPED_BANDS = {
    "UltraGCN": {"valid": (0.038037513568997386, 0.0007387423680386935),
                 "test": (0.03627822436392307, 0.0008663013204134607)},
    "MixGCF": {"valid": (0.20632761418819429, 0.0017986793150566777),
               "test": (0.18469276428222656, 0.0022821446442919785)},
    "PairwiseGMF": {"valid": (0.15015765726566316, 0.011623411276760857),
                    "test": (0.13211882933974267, 0.011198002172033119)},
    "CMN": {"valid": (0.13177550993859768, 0.05672324844704675),
            "test": (0.11733343806117773, 0.04854873012141583)},
}
CMN_REPEAT_EPOCHS = 1  # CMN's epochs trained twice, bit for bit
# CMN's first steps at the shipped width on the card against the same steps
# through the port on the CPU (which tests/test_torch_train_multineg.py holds
# to the JAX package at that width): the band above is too wide to fail an
# untrained CMN, so this is the check that can.
CMN_CPU_STEPS = 5
CMN_CPU_TOL = 1e-5  # |d| of each step's loss, every parameter and rmsprop's nu
# The self-supervised graph models: each recommender, shipped config and the
# epochs its training runs (the cap its JAX band is read at).
SSL_FAMILY = {
    "SimGCL": (SimGCL, "configs/simgcl_default.json", 5),
    "SGL": (SGL, "configs/sgl_default.json", 10),
    "BUIR": (BUIR, "configs/buir_default.json", 10),
    "LCFN": (LCFN, "configs/lcfn_default.json", 10),
}
# (mean, sample std) of best valid and test ndcg@10 over seeds 0-9 of the JAX
# package's training at each shipped config on the structured split, read at
# SSL_FAMILY's caps from runs of 10 (SGL, SimGCL), 20 (BUIR) and 30 (LCFN)
# epochs: `JAX_PLATFORMS=cpu python port_tools/jax_ssl_band.py`. A port run
# must land within mean +- 3 std.
SSL_BANDS = {
    "SimGCL": {"valid": (0.043712081760168074, 0.00596111511328402),
               "test": (0.04386897869408131, 0.004907593624816164)},
    "SGL": {"valid": (0.058004602789878845, 0.0051046440628912445),
            "test": (0.05443970412015915, 0.005306741983629238)},
    "BUIR": {"valid": (0.21944656372070312, 0.011574333014879949),
             "test": (0.1959553763270378, 0.010922941035756544)},
    "LCFN": {"valid": (0.03861007057130337, 0.0002360001956580145),
             "test": (0.037261197715997695, 0.0007469638806129243)},
}
# Random ranking over a user's 101 candidates reads ndcg@10 ~0.045: a band
# whose lower edge lies below this cannot fail an untrained model.
UNTRAINED_NDCG = 0.06
SSL_REPEAT_EPOCHS = 1  # SGL's and BUIR's epochs trained twice, bit for bit
# Each model's first steps at the shipped width on the card against the same
# steps through the port on the CPU (which tests/test_torch_train_ssl.py holds
# to the JAX package), with the same weights, batches and draws: the check
# that can fail an untrained model where its band cannot.
SSL_CPU_STEPS = 5
SSL_CPU_TOL = 1e-5  # |d| of each step's loss (over max(1, |loss|)), every parameter and Adam moment
BUIR_EMA_TOL = 1e-7  # BUIR's target after one step against m * initial + (1 - m) * online
# Adam's first step moves an element by lr * g / (|g| + 1e-8): where |g| is
# near its eps (a gradient that is a near-cancellation of larger terms, its
# rounding on the card and the CPU ~1e-9 apart), that step is set by eps and
# the rounding, not by the model. Elements whose gradient lay below
# SSL_EPS_SET on both sides may pass SSL_CPU_TOL (on an H100, by
# port_tools/ssl_steps_diag.py: one item_emb element of SGL's 168,000 by
# 1.44e-4, of BUIR's by 1.06e-5), at most EPS_SET_SHARE of the elements,
# each within lr a step.
SSL_EPS_SET = 1e-7
EPS_SET_SHARE = 1e-4
# The sequential and VAE models (phases 28-30): each recommender, shipped
# config and the epochs its training runs (the cap its JAX band is read at;
# VAECF runs to early stop inside its config's 200 epochs).
SEQ_FAMILY = {
    "TiSASRec": (TiSASRec, "configs/tisasrec_default.json", 10),
    "NARM": (NARM, "configs/narm_default.json", 5),
    "VAECF": (VAECF, "configs/vaecf_default.json", 200),
}
# (mean, sample std) of best valid and test() ndcg@10 over seeds 0-9 of the
# JAX package's training at each shipped config on the structured split, in
# runs as long as SEQ_FAMILY's caps (10 and 5 epochs; VAECF's to early stop):
# `JAX_PLATFORMS=cpu python port_tools/jax_seq_band.py`. A sequence model's
# test() scores against the train+valid context, the per-epoch test
# evaluator against the train context alone, so a cap is a whole run.
SEQ_BANDS = {
    "TiSASRec": {"valid": (0.04566918909549713, 0.004693966601810954),
                 "test": (0.04335320275276899, 0.008988101033984716)},
    "NARM": {"valid": (0.27208328545093535, 0.005659498303035457),
             "test": (0.25754858255386354, 0.004933453099574731)},
    "VAECF": {"valid": (0.17106172442436218, 0.008142394129761463),
              "test": (0.1476400688290596, 0.007428062552732322)},
}
SEQ_REPEAT_EPOCHS = {"TiSASRec": 2, "NARM": 1, "VAECF": 2}  # each model's epochs trained twice, bit for bit
STEP_UNITS = {"sequence_time": "sequences", "prefix": "examples", "userrow": "user rows",
              "triple": "triples"}  # a step's rows (else positives)
# TiSASRec's band cannot fail an untrained model (its best epoch is 0 in
# most JAX seeds): its first steps at the shipped width on the card are held
# to the same steps through the port on the CPU, with the same batches,
# dropout masks and FFN ReLU decisions (SSL_CPU_TOL, SSL_EPS_SET).
SEQ_CPU_STEPS = 5
SERVE_CPU_TOL = 1e-5  # test() of a checkpoint on the card against the port's on the CPU
VAECF_CHECKPOINT = "VAECF_default_20260821_135516_yybcvt"
# The JAX package's VAECF(cfg).load(VAECF_CHECKPOINT, data).test() on the
# structured split.
EXPECTED_VAECF_METRICS = {"ndcg@10": 0.155424, "recall@10": 0.397667, "precision@10": 0.039767,
                          "map@10": 0.084868}
# The grocery models (phases 32-33) on the structured split with the
# synthetic baskets of examples/parity_check.py: each recommender, shipped
# config and the epochs its training runs (the cap its JAX band is read at).
GROCERY_FAMILY = {
    "Triple2vec": (Triple2vec, "configs/triple2vec_default.json", 5),
    "VBCAR": (VBCAR, "configs/vbcar_default.json", 5),
    "TVBR": (TVBR, "configs/tvbr_default.json", 5),
}
# (mean, sample std) of best valid and test ndcg@10 over seeds 0-9 of the
# JAX package's training at each shipped config, read at GROCERY_FAMILY's
# caps from runs of 20 epochs: `JAX_PLATFORMS=cpu python
# port_tools/jax_grocery_band.py` (VBCAR's and Triple2vec's each from a run
# of its own, read at cap 5). The JAX engine draws its triples unseeded;
# the port from the run's seed.
GROCERY_BANDS = {
    "Triple2vec": {"valid": (0.2430685743689537, 0.006011855701909334),
                   "test": (0.23163970410823823, 0.005162243148011987)},
    "VBCAR": {"valid": (0.2482302561402321, 0.005767608691856849),
              "test": (0.23380966633558273, 0.004666787336907868)},
    "TVBR": {"valid": (0.2315541088581085, 0.010528498129963258),
             "test": (0.2197718933224678, 0.00837311474182661)},
}
GROCERY_REPEAT_EPOCHS = 1  # each model's first epoch (196 steps) trained twice, bit for bit
GROCERY_PROFILED_STEPS = 3  # steps profiled for each model of phases 32-33 (TVBR's ~970 activities a step)
TRIPLE2VEC_CHECKPOINT = "Triple2vec_default_20260821_165054_qjaaht"
# The JAX package's test() of the Triple2vec checkpoint (with the synthetic
# baskets) and of UserKNN and ItemKNN at configs/userKNN_default.json and
# itemKNN_default.json (neighbourhood_size 50) on the structured split:
# `JAX_PLATFORMS=cpu python port_tools/jax_serving_metrics.py`. The card
# must give them to SERVING_TOL.
EXPECTED_TRIPLE2VEC_METRICS = {"ndcg@10": 0.2547794580459595, "recall@10": 0.541887640953064,
                               "precision@10": 0.054188769310712814, "map@10": 0.16939899325370789}
KNN_FAMILY = {"UserKNN": (UserKNN, "configs/userKNN_default.json"),
              "ItemKNN": (ItemKNN, "configs/itemKNN_default.json")}
EXPECTED_KNN_METRICS = {
    "UserKNN": {"ndcg@10": 0.3826568126678467, "recall@10": 0.7073171138763428,
                "precision@10": 0.07073171436786652, "map@10": 0.28375881910324097},
    "ItemKNN": {"ndcg@10": 0.40598830580711365, "recall@10": 0.7179215550422668,
                "precision@10": 0.07179215550422668, "map@10": 0.3105093836784363},
}
SERVING_TOL = 1e-6
# Phases 34-36: the serving surface on the JAX checkpoints, retrieval at
# bench_retrieval_scale's shape and full-state resume. The JAX package's
# FullCatalogEvaluator and TopKRetrievalEvaluator ("exact") metrics of the
# MF, LightGCN and SASRec checkpoints on the structured split (the users
# with a test positive, train items excluded):
# `JAX_PLATFORMS=cpu python port_tools/jax_full_catalog_metrics.py`. The card
# must give them to SERVING_TOL.
EXPECTED_FULL_CATALOG_METRICS = {
    "MF": {
        "full_catalog": {"map@10": 0.022233164070266934, "map@20": 0.026794504386117073,
            "map@5": 0.01569459091947036, "ndcg@10": 0.03626077678271847, "ndcg@20": 0.053398674391486614,
            "ndcg@5": 0.019851945490751133, "precision@10": 0.008483562590840765,
            "precision@20": 0.0076882295618633705, "precision@5": 0.006574761197524005,
            "recall@10": 0.08483563096500531, "recall@20": 0.1537645811240721, "recall@5": 0.032873806998939555},
        "topk_retrieval": {"map@10": 0.022233163325422075, "map@20": 0.026794502351769684,
            "map@5": 0.015694591728525983, "ndcg@10": 0.036260779765719356, "ndcg@20": 0.053398678039836854,
            "ndcg@5": 0.019851944200857393, "precision@10": 0.008483563096500531,
            "precision@20": 0.0076882295618633705, "precision@5": 0.00657476170318377,
            "recall@10": 0.08483563096500531, "recall@20": 0.1537645811240721, "recall@5": 0.032873806998939555},
    },
    "LightGCN": {
        "full_catalog": {"map@10": 0.02512414028131317, "map@20": 0.029653326704039428,
            "map@5": 0.01986567718732395, "ndcg@10": 0.038041366625691776, "ndcg@20": 0.0551520678296701,
            "ndcg@5": 0.025133428239872954, "precision@10": 0.008165429278117855,
            "precision@20": 0.007529162147012268, "precision@5": 0.008271473210032394,
            "recall@10": 0.0816542948038176, "recall@20": 0.15058324496288442, "recall@5": 0.041357370095440084},
        "topk_retrieval": {"map@10": 0.02512413944015217, "map@20": 0.029653329025885158,
            "map@5": 0.01986567691763874, "ndcg@10": 0.03804136402547644, "ndcg@20": 0.05515205323801627,
            "ndcg@5": 0.02513342539109289, "precision@10": 0.008165429278117855,
            "precision@20": 0.007529162652672033, "precision@5": 0.008271474221351922,
            "recall@10": 0.0816542948038176, "recall@20": 0.15058324496288442, "recall@5": 0.041357370095440084},
    },
    "SASRec": {
        "full_catalog": {"map@10": 0.07244483891120013, "map@20": 0.08002185518137345,
            "map@5": 0.06173558806563991, "ndcg@10": 0.10322858015527654, "ndcg@20": 0.1311964518444915,
            "ndcg@5": 0.07760667042413673, "precision@10": 0.020466597183890965,
            "precision@20": 0.015800638896663013, "precision@5": 0.025238603448311574,
            "recall@10": 0.2046659597030753, "recall@20": 0.31601272534464475, "recall@5": 0.1261930010604454},
    },
}
SERVING_FAMILY = {"MF": (MatrixFactorization, MF_CHECKPOINT),
                  "LightGCN": (LightGCN, os.path.join(REPO, "parity_runs/checkpoints", GRAPH_FAMILY["LightGCN"][2])),
                  "SASRec": (SASRec, CHECKPOINT)}
# bench.py's bench_retrieval_scale: 10,240 users x 162,000 items, MF tables of
# emb 64 (66 wide with the biases), k 10, 20 excluded ids a user.
RETRIEVAL_SCALE = {"n_users": 10_240, "n_items": 162_000, "emb_dim": 64, "k": 10, "t": 20}
RETRIEVAL_CPU_USERS = 256  # users whose exact ids are held against a full sort on the CPU
RETRIEVAL_ITEM_BLOCK = 8192
RECALL_TARGET = 0.95  # the JAX package's default recall_target for the bf16 scores
RESUME_EPOCHS = 1  # phase 36: this many epochs, resumed for as many more, against twice as many straight
DENSE_MESH_EPOCHS = 2  # phase 37's mesh runs held against their references
BF16_STEPS = 5  # phase 38: SASRec's bfloat16 steps, card against the CPU
BF16_TOL = 2e-2  # phase 38: those steps' losses (relative), parameters and moments, bfloat16 on both sides
BF16_SASREC_EPOCHS = 2  # phase 38's bfloat16 SASRec training
BF16_TEST_TOL = 1e-3  # phase 38: test() of the bfloat16 SASRec, card against the CPU
MF_BF16_EPOCHS = 5  # phase 38's bfloat16 lazy-Adam MF training (10 before phase 40 came)
# (mean, sample std) of best valid and test ndcg@10 over seeds 0-9 of the JAX
# package's MF + BPR lazy-Adam training in bfloat16 (model.compute_dtype),
# read at MF_BF16_EPOCHS: `JAX_PLATFORMS=cpu python port_tools/jax_mf_band.py
# --compute_dtype bfloat16`.
MF_BF16_BAND = {"valid": (0.18792699724435807, 0.005163802040448501),
                "test": (0.16793174892663956, 0.009733372578416027)}
RATES = {}  # phase -> its training's examples or sequences a second, each epoch
SASREC_MESH_STEPS = 5  # phase 37: SASRec's steps at the shipped dropout on a (4, 1) mesh, card against the CPU
MESH_EVAL_TOL = 1e-6  # phase 37: a mesh's evaluators against one device's

T0 = time.perf_counter()


PHASE_SECONDS = {}  # phase -> its seconds in this run (``mark``)
_RUNNING = [None, 0.0]  # the phase running since the last mark, and when it began


def mark(phase=None):
    """Close the phase running since the last mark, its seconds into
    PHASE_SECONDS, and start ``phase`` (None: start none)."""
    now = time.perf_counter()
    if _RUNNING[0] is not None:
        PHASE_SECONDS[_RUNNING[0]] = round(PHASE_SECONDS.get(_RUNNING[0], 0.0) + now - _RUNNING[1], 2)
    _RUNNING[:] = [phase, now]


def log(phase, msg):
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card (CUDA events around ``reps``
    back-to-back calls, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, kernel, reps=20):
    """Mean device milliseconds of the CUDA kernels whose name holds
    ``kernel`` over ``reps`` calls of ``fn``, from ``torch.profiler``: the
    kernel's own time, whatever the host takes to launch it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and kernel in e.key]
    count = sum(e.count for e in hits)
    if not count:
        return None  # the profiler saw no device activity: not measured
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def queued_ms(fn, devices=("cuda",), reps=20, sleep_cycles=40_000_000):
    """Mean device milliseconds a call of ``fn``, whatever the host takes:
    ``reps`` calls queued behind a sleep kernel on every card of
    ``devices`` (~20 ms at the H100's clocks, longer than the host takes to
    queue them), timed by CUDA events on the first card's stream. Calls
    that span several cards include their waits for each other. Fails if
    the host did not finish queueing before the sleep ended."""
    cards = list(dict.fromkeys(torch.device(d) for d in devices))

    def sleep(cycles):
        for device in cards:
            with torch.cuda.device(device):
                torch.cuda._sleep(cycles)

    fn()
    sleep(1)  # the sleep kernel's first launch on a card loads it: not inside the timing
    sync_all(devices)
    first = cards[0]
    sleep_start, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    sleep_start.record(torch.cuda.current_stream(first))
    sleep(sleep_cycles)
    start.record(torch.cuda.current_stream(first))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record(torch.cuda.current_stream(first))
    end.synchronize()
    sync_all(devices)
    if host_ms > sleep_start.elapsed_time(start):
        fail(f"queueing {reps} calls took {host_ms:.2f} ms, longer than the sleep meant to cover it")
    return start.elapsed_time(end) / reps


def device_breakdown(fn, top=5, kernel=None, steps=None):
    """One profiled call of ``fn``: its wall time, the device's busy share of
    it (device time of kernels and copies over wall time), the ``top``
    device activities by time, with ``kernel`` the time of the kernels whose
    name holds it and with ``steps`` the device activities a step. The
    profiler adds host overhead to the wall time, so the busy share is a
    lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # User annotations (e.g. "Optimizer.step#Adam.step") span kernels that
    # are counted on their own: leave them out of the sum.
    on_device = sorted(
        ((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
         and not getattr(e, "is_user_annotation", False)),
        reverse=True,
    )
    if not on_device:
        return f"profiled wall {wall_us / 1e3:.2f} ms; device time not measured (no CUDA events)"
    busy_us = sum(t for t, _, _ in on_device)
    tops = "; ".join(f"{key[:60]} x{count} {t / 1e3:.3f} ms" for t, key, count in on_device[:top])
    mine = ""
    if kernel is not None:
        hits = [(t, c) for t, key, c in on_device if kernel in key]
        t_us = sum(t for t, _ in hits)
        mine = (f"; {kernel} x{sum(c for _, c in hits)} {t_us / 1e3:.3f} ms "
                f"({100 * t_us / busy_us:.1f}% of device busy)")
    n_ops = sum(c for _, _, c in on_device)
    per_step = f" ({n_ops / steps:.1f} a step)" if steps else ""
    return (f"profiled wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.3f} ms "
            f"({100 * busy_us / wall_us:.1f}%, idle {100 - 100 * busy_us / wall_us:.1f}%) in {n_ops} "
            f"device activities{per_step}; top: {tops}{mine}")


def profile_window(trainer, generator, steps=PROFILED_WINDOW, **kwargs):
    """``device_breakdown`` of forming an epoch's batches (its permutation and
    its whole draw of negatives) and training its first ``steps`` steps (the
    profiler takes ~0.5 ms of host time to read each device activity: a
    whole epoch of mf-sparse, 64,000 of them, took 32 s)."""

    def window():
        batches = [x[:steps] for x in trainer.form(generator)]
        return float(trainer.run_batches(*batches, generator=generator))

    return device_breakdown(window, steps=min(steps, trainer.num_batches), **kwargs)


def attention_bound(n, t, dh, dtype):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (q, k, v read once, out and lse written once) over the HBM rate and the
    FLOPs of the visible (query, key) pairs (4 * dh each) over the peak rate
    of the input type."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = n * t * (4 * dh * itemsize + 4)
    flops = 4 * dh * n * t * (t + 1) // 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_forward(row, out, lse, ref_out, ref_lse, dtype):
    """The forward kernel's (out, lse) against its plain version's, within
    TOL: out absolute in float32, one bfloat16 step in bfloat16. Records
    the largest differences in ``row``."""
    d_out = (out.float() - ref_out.float()).abs()
    tol = TOL[dtype]
    scale = ref_out.float().abs().clamp(min=1.0) if dtype == torch.bfloat16 else 1.0
    row["max_abs_err"] = float(d_out.max())
    row["lse_max_abs_err"] = float((lse - ref_lse).abs().max())
    if (not bool((d_out <= tol["out"] * scale).all()) or row["lse_max_abs_err"] > tol["lse"]
            or not torch.isfinite(out.float()).all()):
        fail(f"flash kernel disagrees with its plain version: {row}, tolerances {tol}")


def compare_flash(n, t, dh, dtype, gen, timed):
    """Kernel vs plain version on one random (n, t, dh) input; returns a row."""
    q, k, v = (torch.randn(n, t, dh, generator=gen, device="cuda").to(dtype) for _ in range(3))
    out, lse = flash_causal_attention(q, k, v)
    ref_out, ref_lse = flash_causal_attention_reference(q, k, v)
    torch.cuda.synchronize()
    row = {"shape": [n, t, dh], "dtype": str(dtype).replace("torch.", "")}
    check_forward(row, out, lse, ref_out, ref_lse, dtype)
    if timed:
        row["ms"] = cuda_ms(lambda: flash_causal_attention(q, k, v))
        row["plain_ms"] = cuda_ms(lambda: flash_causal_attention_reference(q, k, v))
        row["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
        )
        row["bound_ms"], row["bound_by"] = attention_bound(n, t, dh, dtype)
        log("flash", f"{n}x{t}x{dh} {row['dtype']}: kernel {row['ms'] * 1e3:.1f} us, plain "
            f"{row['plain_ms'] * 1e3:.1f} us, library {row['library_ms'] * 1e3:.1f} us, bound "
            f"{row['bound_ms'] * 1e3:.1f} us by {row['bound_by']} "
            f"({100 * row['bound_ms'] / row['ms']:.1f}% of bound)")
    return row


def attention_bwd_bound(n, t, dh, dtype):
    """(bound_ms, bound_by) of the backward: the larger of the bytes it must
    move (q, k, v, dout and lse read once; dq, dk, dv written once)
    over the HBM rate and ~10 * dh FLOPs per visible (query, key) pair
    (recomputing q.k and dout.v, and the products into dq, dk and dv) over
    the peak rate of the input type."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = n * t * (7 * dh * itemsize + 4)
    flops = 10 * dh * n * t * (t + 1) // 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def within(got, want, limit):
    """max |got - want| and whether every |d| <= limit * max(1, |want|)."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= limit * want.float().abs().clamp(min=1.0)).all()) and bool(torch.isfinite(got.float()).all())
    return float(err.max()), ok


def kernel_keep_masks(n, t, dh, dtype, rate, seed):
    """The keep masks the forward and the backward kernels applied, read off
    their outputs: with q = k = 0 every visible probability is 1/(row + 1),
    so with v (forward) or dout (backward) one-hot over a block of dh rows,
    out[i, j] and dv[j, i] are 0 exactly where entry (i, j) was dropped."""
    q = torch.zeros(n, t, dh, device="cuda", dtype=dtype)
    fwd = torch.zeros(n, t, t, dtype=torch.bool, device="cuda")
    bwd = torch.zeros_like(fwd)
    for c0 in range(0, t, dh):
        onehot = torch.zeros(n, t, dh, device="cuda", dtype=dtype)
        cols = torch.arange(c0, min(c0 + dh, t), device="cuda")
        onehot[:, cols, cols - c0] = 1.0
        out, lse = flash_causal_attention(q, q, onehot, rate, seed)
        _, _, dv = flash_causal_attention_bwd(q, q, onehot, lse, onehot, rate, seed)
        fwd[:, :, cols] = out[:, :, : len(cols)] != 0
        bwd[:, cols, :] = dv[:, :, : len(cols)].transpose(1, 2) != 0
    return fwd, bwd


def compare_flash_train(n, t, dh, dtype, rate, gen):
    """Forward and backward kernels against their plain versions (autograd
    through the plain forward) at one shape, dropout included; at rate > 0
    the masks of both kernels bit-equal to the plain mask and the keep share
    within 5 binomial sigmas. Returns a row."""
    q, k, v, do = (torch.randn(n, t, dh, generator=gen, device="cuda").to(dtype) for _ in range(4))
    seed = torch.randint(0, 2**62, (1,), generator=gen, device="cuda")
    out, lse = flash_causal_attention(q, k, v, rate, seed)
    grads = flash_causal_attention_bwd(q, k, v, lse, do, rate, seed)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ref, ref_lse = flash_causal_attention_reference(*leaves, rate, seed)
    want = torch.autograd.grad(ref, leaves, do)
    torch.cuda.synchronize()
    row = {"shape": [n, t, dh], "dtype": str(dtype).replace("torch.", ""), "rate": rate}
    check_forward(row, out, lse, ref.detach(), ref_lse.detach(), dtype)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        row[f"{name}_max_abs_err"], ok = within(got, w, GRAD_TOL[dtype])
        if not ok or got.dtype != dtype:
            fail(f"flash backward {name} disagrees with the plain backward: {row}, limit {GRAD_TOL[dtype]}")
    row["bwd_max_abs_err"] = max(row[f"{name}_max_abs_err"] for name in ("dq", "dk", "dv"))
    if rate > 0:
        fwd_mask, bwd_mask = kernel_keep_masks(n, t, dh, dtype, rate, seed)
        want_mask = dropout_keep_mask(seed, n, t, rate) & torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
        if not (torch.equal(fwd_mask, want_mask) and torch.equal(bwd_mask, want_mask)):
            fail(f"flash dropout masks differ from the plain mask: {row}")
        pairs = n * t * (t + 1) // 2
        row["keep_share"] = int(want_mask.sum()) / pairs
        sigma = (rate * (1 - rate) / pairs) ** 0.5
        if abs(row["keep_share"] - (1 - rate)) > 5 * sigma:
            fail(f"keep share {row['keep_share']} is more than 5 sigmas ({sigma:.2e}) from {1 - rate}: {row}")
    return row


def time_flash_train(n, t, dh, dtype, rate, gen):
    """Times of the forward and backward kernels, their plain versions and
    SDPA (forward and backward, is_causal, rate 0: a yardstick the port
    never calls) at one shape, with the bounds. Returns a row."""
    q, k, v, do = (torch.randn(n, t, dh, generator=gen, device="cuda").to(dtype) for _ in range(4))
    seed = torch.randint(0, 2**62, (1,), generator=gen, device="cuda")
    _, lse = flash_causal_attention(q, k, v, rate, seed)
    row = {"shape": [n, t, dh], "dtype": str(dtype).replace("torch.", ""), "rate": rate}
    row["fwd_ms"] = cuda_ms(lambda: flash_causal_attention(q, k, v, rate, seed))
    row["fwd_plain_ms"] = cuda_ms(lambda: flash_causal_attention_reference(q, k, v, rate, seed))
    row["bwd_ms"] = cuda_ms(lambda: flash_causal_attention_bwd(q, k, v, lse, do, rate, seed))
    row["bwd_device_ms"] = queued_ms(lambda: flash_causal_attention_bwd(q, k, v, lse, do, rate, seed))
    row["bwd_plain_ms"] = cuda_ms(lambda: flash_causal_attention_bwd_reference(q, k, v, lse, do, rate, seed))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["fwd_library_ms"] = cuda_ms(lambda: sdpa(q, k, v, is_causal=True))
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    lib_out = sdpa(*leaves, is_causal=True)
    row["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True))
    row["fwd_bound_ms"], row["fwd_bound_by"] = attention_bound(n, t, dh, dtype)
    row["bwd_bound_ms"], row["bwd_bound_by"] = attention_bwd_bound(n, t, dh, dtype)
    log("flash", f"{n}x{t}x{dh} {row['dtype']} rate {rate}: forward kernel {row['fwd_ms'] * 1e3:.1f} us, plain "
        f"{row['fwd_plain_ms'] * 1e3:.1f} us, SDPA {row['fwd_library_ms'] * 1e3:.1f} us, bound "
        f"{row['fwd_bound_ms'] * 1e3:.1f} us by {row['fwd_bound_by']}; backward kernel {row['bwd_ms'] * 1e3:.1f} us "
        f"(queued on the device {row['bwd_device_ms'] * 1e3:.1f} us), "
        f"plain {row['bwd_plain_ms'] * 1e3:.1f} us, SDPA {row['bwd_library_ms'] * 1e3:.1f} us, bound "
        f"{row['bwd_bound_ms'] * 1e3:.1f} us by {row['bwd_bound_by']} "
        f"({100 * row['bwd_bound_ms'] / row['bwd_device_ms']:.1f}% of bound)")
    return row


def rowadam_bound(n_touched, d, n_ids, id_bytes=8):
    """(bound_ms, bound_by) of one lazy-Adam row update: each touched row
    reads table, m, v and its gradient row and writes table, m and v (7 rows
    of d float32), and every id is read once; 12 FLOPs a touched element
    over the float32 peak."""
    nbytes = n_touched * 7 * d * 4 + n_ids * id_bytes
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 12 * n_touched * d / PEAK_FLOPS[torch.float32] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def rowadam_inputs(n_rows, n_ids, d, seed, device, zipf=False):
    """(table, m, v, ids, grads) for one lazy-Adam row update: random tables
    and moments, ids uniform or zipf-distributed (duplicates either way),
    every 7th gradient row all zero, and the last two rows one unused id
    whose gradients cancel to zero once summed."""
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.2, n_ids) - 1) % n_rows if zipf else rng.integers(0, n_rows, n_ids)
    ids[-2:] = np.setdiff1d(np.arange(min(n_rows, n_ids + 2)), ids[:-2])[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn(n_rows, d, generator=gen, device=device)
    m = 0.1 * torch.randn(n_rows, d, generator=gen, device=device)
    v = (0.1 * torch.randn(n_rows, d, generator=gen, device=device)).abs()
    grads = torch.randn(n_ids, d, generator=gen, device=device)
    grads[::7] = 0.0
    grads[-1] = -grads[-2]
    return table, m, v, torch.as_tensor(ids, device=device), grads


def compare_rowadam(n_rows, n_ids, d, seed, zipf=False, timed=False):
    """Kernel vs plain version on one input; returns a row. Also times the
    kernel, the plain version and torch.optim.SparseAdam's step on the same
    (ids, gradient rows) when ``timed``."""
    table, m, v, ids, grads = rowadam_inputs(n_rows, n_ids, d, seed, "cuda", zipf)
    ids_s, g_d = _segment_dedup(ids, grads)
    bc, lr = bias_corrections(3), 0.05
    want = fused_rowadam_reference(table.clone(), m.clone(), v.clone(), ids_s, g_d, bc, lr)
    got = fused_rowadam(table.clone(), m.clone(), v.clone(), ids_s, g_d, bc, lr)
    torch.cuda.synchronize()
    touched = ids_s[(g_d != 0).any(dim=1)]
    untouched = torch.ones(n_rows, dtype=torch.bool, device="cuda")
    untouched[touched] = False
    row = {"shape": [n_rows, d], "n_ids": n_ids, "ids": "zipf" if zipf else "uniform",
           "touched_rows": int(touched.numel()), "max_abs_err": 0.0}
    for name, g, w, orig in zip(("table", "m", "v"), got, want, (table, m, v)):
        err = (g - w).abs()
        row["max_abs_err"] = max(row["max_abs_err"], float(err.max()))
        if not bool((err <= ROWADAM_ATOL + ROWADAM_RTOL * w.abs()).all()) or not torch.isfinite(g).all():
            fail(f"fused_rowadam {name} disagrees with its plain version: {row}")
        if not torch.equal(g[untouched], orig[untouched]):
            fail(f"fused_rowadam wrote {name} rows it was not given a gradient for: {row}")
    if timed:
        work = (table.clone(), m.clone(), v.clone())
        row["ms"] = cuda_ms(lambda: fused_rowadam(*work, ids_s, g_d, bc, lr))
        row["plain_ms"] = cuda_ms(lambda: fused_rowadam_reference(*work, ids_s, g_d, bc, lr))
        param = torch.nn.Parameter(table.clone())
        sparse_adam = torch.optim.SparseAdam([param], lr=lr)
        coo = torch.sparse_coo_tensor(ids[None], grads, table.shape)

        def library():
            param.grad = coo
            sparse_adam.step()

        row["library_ms"] = cuda_ms(library)
        row["device_ms"] = kernel_device_ms(lambda: fused_rowadam(*work, ids_s, g_d, bc, lr), "rowadam_kernel")
        row["bound_ms"], row["bound_by"] = rowadam_bound(row["touched_rows"], d, n_ids)
        device = "not measured" if row["device_ms"] is None else f"{row['device_ms'] * 1e3:.2f} us"
        log("rowadam", f"{n_rows}x{d}, L={n_ids} {row['ids']} ids, {row['touched_rows']} touched rows: wrapper call "
            f"{row['ms'] * 1e3:.2f} us (kernel alone on the device {device}), plain {row['plain_ms'] * 1e3:.2f} us, "
            f"SparseAdam {row['library_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.3f} us by {row['bound_by']}")
    return row


def compare_rowadam_group(cases, seed, timed=False):
    """The grouped kernel, one launch for the tables of ``cases`` ((n_rows,
    L, d) each, uniform ids) through a group built beforehand as the trainer
    builds it, against the plain version of each table in order; returns a
    row. Also times the group, the plain versions and one
    torch.optim.SparseAdam step over all the tables when ``timed``."""
    # Imported here: port_tools/time_kernels.py imports this module beside
    # older checkouts of the package, which have no grouped entry.
    from beta_recsys_tpu_torch.ops.kernels.rowadam import RowAdamTables, fused_rowadam_tables_reference

    tables, ids, grads, coos, untouched = [], [], [], [], []
    for i, (n_rows, n_ids, d) in enumerate(cases):
        table, m, v, idx, g = rowadam_inputs(n_rows, n_ids, d, seed + i, "cuda")
        ids_s, g_d = _segment_dedup(idx, g)
        tables.append((table, m, v))
        ids.append(ids_s)
        grads.append(g_d)
        coos.append(torch.sparse_coo_tensor(idx[None], g, table.shape))
        mask = torch.ones(n_rows, dtype=torch.bool, device="cuda")
        mask[ids_s[(g_d != 0).any(dim=1)]] = False
        untouched.append(mask)
    bc, lr = bias_corrections(3), 0.05
    want = fused_rowadam_tables_reference([tuple(x.clone() for x in t) for t in tables], ids, grads, bc, lr)
    got = [tuple(x.clone() for x in t) for t in tables]
    group = RowAdamTables(got)
    launches = fused_rowadam.launches
    group(ids, grads, bc, lr)
    torch.cuda.synchronize()
    row = {"shapes": [[n_rows, d, n_ids] for n_rows, n_ids, d in cases],
           "touched_rows": sum(int((~u).sum()) for u in untouched), "max_abs_err": 0.0}
    if fused_rowadam.launches != launches + 1:
        fail(f"a grouped fused_rowadam call launched {fused_rowadam.launches - launches} times, not once: {row}")
    for g_t, w_t, orig, u in zip(got, want, tables, untouched):
        for name, g, w, o in zip(("table", "m", "v"), g_t, w_t, orig):
            err = (g - w).abs()
            row["max_abs_err"] = max(row["max_abs_err"], float(err.max()))
            if not bool((err <= ROWADAM_ATOL + ROWADAM_RTOL * w.abs()).all()) or not torch.isfinite(g).all():
                fail(f"grouped fused_rowadam {name} disagrees with the plain version: {row}")
            if not torch.equal(g[u], o[u]):
                fail(f"grouped fused_rowadam wrote {name} rows it was not given a gradient for: {row}")
    if timed:
        work = [tuple(x.clone() for x in t) for t in tables]
        work_group = RowAdamTables(work)

        def kernel():
            work_group(ids, grads, bc, lr)

        row["ms"] = cuda_ms(kernel)
        row["queued_ms"] = queued_ms(kernel)
        row["device_ms"] = kernel_device_ms(kernel, "rowadam_kernel")
        row["plain_ms"] = cuda_ms(lambda: fused_rowadam_tables_reference(work, ids, grads, bc, lr))
        params = [torch.nn.Parameter(t[0].clone()) for t in tables]
        sparse_adam = torch.optim.SparseAdam(params, lr=lr)

        def library():
            for p, coo in zip(params, coos):
                p.grad = coo
            sparse_adam.step()

        row["library_ms"] = cuda_ms(library)
        bounds = [rowadam_bound(int((~u).sum()), d, n_ids)[0] for u, (_, n_ids, d) in zip(untouched, cases)]
        row["bound_ms"], row["bound_by"] = sum(bounds), "bytes"
        device = "not measured" if row["device_ms"] is None else f"{row['device_ms'] * 1e3:.2f} us"
        log("rowadam", f"one launch for {row['shapes']} ([n_rows, d, L] each), {row['touched_rows']} touched rows: "
            f"call {row['ms'] * 1e3:.2f} us, queued on the device {row['queued_ms'] * 1e3:.2f} us (kernel alone "
            f"{device}), plain {row['plain_ms'] * 1e3:.2f} us, SparseAdam {row['library_ms'] * 1e3:.2f} us, "
            f"bound {row['bound_ms'] * 1e3:.3f} us by bytes")
    return row


def mf_split():
    return BaseData(load_split_data(SPLIT, n_test=1))


def mf_config(seed, root_dir, **model):
    """configs/mf_default.json on the structured synthetic split, one
    evaluation copy, as the JAX package's parity runs train it."""
    return load_config(MF_CONFIG).replace(
        system={"root_dir": root_dir, "seed": seed},
        dataset={"dataset": "synthetic_structured", "n_test": 1},
        model=model,
    )


def band_position(what, value, band):
    """Where ``value`` lies against the JAX band mean +- 3 std."""
    mean, std = band
    lo, hi = mean - 3 * std, mean + 3 * std
    return f"{what} {value:.6f} {'in' if lo <= value <= hi else 'OUTSIDE'} [{lo:.4f}, {hi:.4f}]"


def in_band(what, value, band):
    """``band_position``, failing outside the band."""
    text = band_position(what, value, band)
    if "OUTSIDE" in text:
        fail(f"{text}, the JAX band (mean {band[0]:.4f} +- 3 x {band[1]:.4f})")
    return text


def train_mf(phase, seed, root_dir, **model):
    """Train MF through MatrixFactorization(cfg).train(data); returns the
    recommender, the train result, the fused_rowadam launches counted from 0
    around train() alone, and the test() row."""
    data = mf_split()
    rec = MatrixFactorization(mf_config(seed, root_dir, **model))
    fused_rowadam.launches = 0
    result = rec.train(data)
    torch.cuda.synchronize()
    launches = fused_rowadam.launches
    res = rec.test()
    engine = rec.engine
    rates = RATES[phase] = [engine.epoch_fn.padded_size / s for s in engine.epoch_seconds]
    log(phase, f"{len(rates)} epochs of {engine.epoch_fn.num_batches} steps x {engine.epoch_fn.batch_size}, "
        f"best epoch {result['best_epoch']}, train() {result['run_time']:.2f} s; examples/s per epoch: "
        + ", ".join(f"{r:.0f}" for r in rates))
    log(phase, f"examples/s after the first epoch: median {np.median(rates[1:]):.1f}, "
        f"min {min(rates[1:]):.1f}, max {max(rates[1:]):.1f}")
    log(phase, f"best valid ndcg@10 {result['valid_metric']:.6f}; test() "
        + ", ".join(f"{k} {res[k]:.6f}" for k in EXPECTED_MF_METRICS))
    return rec, result, launches, res


def check_mf_serving(phase, rec):
    k = 10
    recs = rec.recommend(k=k)
    torch.cuda.synchronize()
    check_recommendations(recs, rec.data, k, rec.data.n_users)
    pairs = {c: rec.data.test[0][c][:300] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    scores = rec.predict(pairs)
    if scores.shape != (300,) or not np.isfinite(scores).all() or (scores < 0).any() or (scores > 1).any():
        fail(f"predict() gave {scores.shape} scores outside [0, 1] or non-finite")
    log(phase, f"recommend(k={k}) {rec.data.n_users} users well-formed, no train item; predict(300 pairs) in [0, 1]")


def mf_sparse_training(seed, root_dir):
    """Phase 3. Returns fused_rowadam's launches on the path (train() alone)."""
    rec, result, launches, res = train_mf("mf-sparse", seed, root_dir, sparse_optim=True, row_update="fused",
                                          max_epoch=MF_SPARSE_EPOCHS)
    steps = len(rec.engine.bookkeeper.history) * rec.engine.epoch_fn.num_batches
    check_launches("fused_rowadam", "mf-sparse", launches, steps)
    log("mf-sparse", f"(cap {MF_SPARSE_EPOCHS} epochs) "
        + in_band("best valid ndcg@10", result["valid_metric"], SPARSE_BAND_AT_CAP["valid"]) + "; "
        + in_band("test ndcg@10", res["ndcg@10"], SPARSE_BAND_AT_CAP["test"]))
    check_mf_serving("mf-sparse", rec)
    log("mf-sparse", f"{PROFILED_WINDOW} steps: " + profile_window(rec.engine.epoch_fn, rec.engine.generator, top=8,
                                                                    kernel="rowadam_kernel"))
    return launches


def mf_dense_training(seed, root_dir):
    """Phase 4: the dense trainer runs no fused_rowadam."""
    rec, _, launches, res = train_mf("mf-dense", seed, root_dir, max_epoch=MF_DENSE_EPOCHS)
    if launches:
        fail(f"the dense trainer launched fused_rowadam {launches} times")
    log("mf-dense", in_band("test ndcg@10", res["ndcg@10"], DENSE_BAND["test"]))
    check_mf_serving("mf-dense", rec)


def serve_mf_checkpoint(root_dir):
    """Phase 5: the JAX-trained MF checkpoint gives the JAX package's metrics."""
    cfg = load_config(MF_CHECKPOINT).replace(system={"root_dir": root_dir})
    rec = MatrixFactorization(cfg).load(MF_CHECKPOINT, mf_split())
    res = rec.test()
    for key, want in EXPECTED_MF_METRICS.items():
        if abs(res[key] - want) > METRIC_TOL:
            fail(f"MF checkpoint test() {key} = {res[key]:.6f}, expected {want} +- {METRIC_TOL}")
    log("mf-serve", "test() " + ", ".join(f"{k} {res[k]:.6f}" for k in EXPECTED_MF_METRICS)
        + f" (expected to {METRIC_TOL})")
    check_mf_serving("mf-serve", rec)


def ml1m_shaped_split(seed, n_users=6040, n_items=3706, n_interactions=1_000_209,
                      max_per_user=2314, n_negative=100):
    """A leave-one-out split shaped like MovieLens-1M, made with numpy.

    Every user has 20 to ``max_per_user`` interactions (MovieLens-1M's least
    and most), a long-tailed count; items
    are drawn without repetition per user, biased toward popular ones; the
    newest interaction of each user is the test positive, the one before it
    the validation positive, each beside ``n_negative`` sampled items the
    user never interacted with. Returns (train, [valid], [test]) frames.
    """
    rng = np.random.default_rng(seed)
    weights = rng.lognormal(0.0, 1.2, n_users)
    extra = np.floor(weights / weights.sum() * (n_interactions - 20 * n_users)).astype(np.int64)
    counts = np.minimum(20 + extra, max_per_user)
    while (short := n_interactions - counts.sum()) > 0:
        np.add.at(counts, rng.choice(np.nonzero(counts < max_per_user)[0], short), 1)
        counts = np.minimum(counts, max_per_user)
    # Gumbel top-k: per user, items in order of log(popularity) + Gumbel noise
    # is a draw without replacement weighted by popularity.
    log_pop = -0.8 * np.log(np.arange(n_items) + 10.0)
    users, items = [], []
    for lo in range(0, n_users, 512):
        hi = min(lo + 512, n_users)
        keys = log_pop[None, :] + rng.gumbel(size=(hi - lo, n_items))
        order = np.argsort(-keys, axis=1)
        take = np.arange(n_items)[None, :] < counts[lo:hi, None]
        users.append(np.broadcast_to(np.arange(lo, hi)[:, None], take.shape)[take])
        items.append(order[take])
    users, items = np.concatenate(users), np.concatenate(items)
    stamps = rng.integers(956_703_932, 1_046_454_590, size=len(users))
    order = np.lexsort((stamps, users))
    users, items, stamps = users[order], items[order], stamps[order]
    from_end = np.repeat(np.cumsum(counts), counts) - np.arange(len(users))  # 1 = newest

    def frame(sel, ratings=None):
        return {
            DEFAULT_USER_COL: users[sel] + 1, DEFAULT_ITEM_COL: items[sel] + 1,
            DEFAULT_RATING_COL: np.ones(int(sel.sum()), np.float32),
            DEFAULT_TIMESTAMP_COL: stamps[sel],
        }

    seen = np.zeros((n_users, n_items), dtype=bool)
    seen[users, items] = True

    def with_negatives(pos):
        neg_u = np.repeat(np.arange(n_users), n_negative)
        neg_i = rng.integers(0, n_items, size=len(neg_u))
        while True:
            bad = seen[neg_u, neg_i]
            if not bad.any():
                break
            neg_i[bad] = rng.integers(0, n_items, size=int(bad.sum()))
        return {
            DEFAULT_USER_COL: np.concatenate([pos[DEFAULT_USER_COL], neg_u + 1]),
            DEFAULT_ITEM_COL: np.concatenate([pos[DEFAULT_ITEM_COL], neg_i + 1]),
            DEFAULT_RATING_COL: np.concatenate(
                [pos[DEFAULT_RATING_COL], np.zeros(len(neg_u), np.float32)]
            ),
            DEFAULT_TIMESTAMP_COL: np.concatenate(
                [pos[DEFAULT_TIMESTAMP_COL], np.zeros(len(neg_u), np.int64)]
            ),
        }

    train = frame(from_end > 2)
    valid = with_negatives(frame(from_end == 2))
    test = with_negatives(frame(from_end == 1))
    return train, [valid], [test]


def check_recommendations(rec, data, k, n_users):
    items = rec[DEFAULT_ITEM_COL].reshape(n_users, k)
    scores = rec[DEFAULT_PREDICTION_COL].reshape(n_users, k)
    if not np.isfinite(scores).all():
        fail("recommend() returned non-finite scores")
    if (np.diff(scores, axis=1) > 0).any():
        fail("recommend() rows are not in descending score order")
    train = data.user_item_csr()
    users = rec[DEFAULT_USER_COL].reshape(n_users, k)[:, 0]
    hit = np.asarray(train[np.repeat(users, k), items.reshape(-1)]).reshape(-1) > 0
    if hit.any():
        fail(f"recommend() returned {int(hit.sum())} train items")


def same_top_k(rec, ref, k):
    """Top-k lists of the kernel path and of the plain path agree: scores at
    each rank to 1e-4, and where the items at a rank differ, their scores lie
    within NEAR_TIE (the two items tie up to float32 rounding). Returns the
    number of rows that differ."""
    a = rec[DEFAULT_ITEM_COL].reshape(-1, k)
    b = ref[DEFAULT_ITEM_COL].reshape(-1, k)
    gap = np.abs(rec[DEFAULT_PREDICTION_COL] - ref[DEFAULT_PREDICTION_COL]).reshape(-1, k)
    if gap.max() > 1e-4:
        fail(f"top-{k} scores differ from the plain path by {gap.max()}")
    swapped = (a != b) & (gap > NEAR_TIE)
    if swapped.any():
        u = int(np.nonzero(swapped.any(axis=1))[0][0])
        fail(f"top-{k} of row {u} differs beyond near-ties: {a[u]} vs {b[u]}")
    return int((a != b).any(axis=1).sum())


def check_launches(kernel, path, launches, expected):
    """The kernel ran on ``path`` exactly as often as the path needs it."""
    if launches != expected or launches == 0:
        fail(f"{kernel} launched {launches} times on the {path} path, expected {expected}")
    log(path, f"{kernel} launches on the path: {launches} (= {expected} expected)")


def serve_checkpoint(root_dir):
    """Phase 3. Returns the flash kernel's launches in the path's counted
    calls: load, test() twice, predict(), recommend() twice."""
    data = SequentialData(load_split_data(SPLIT, n_test=1))
    cfg = load_config(CHECKPOINT).replace(system={"root_dir": root_dir})
    log("serve", f"split: {data.n_users} users, {data.n_items} items, "
        f"{len(data.train[DEFAULT_USER_COL])} train rows")

    flash_causal_attention.launches = 0
    rec = SASRec(cfg).load(CHECKPOINT, data)
    res = rec.test()
    torch.cuda.synchronize()
    for key, want in EXPECTED_METRICS.items():
        if abs(res[key] - want) > METRIC_TOL:
            fail(f"test() {key} = {res[key]:.6f}, expected {want} +- {METRIC_TOL}")
    log("serve", "test() " + ", ".join(f"{k} {res[k]:.6f}" for k in EXPECTED_METRICS)
        + f" (expected to {METRIC_TOL})")
    t0 = time.perf_counter()
    rec.test()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0

    pairs = {c: data.test[0][c][:300] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    scores = rec.predict(pairs)
    if scores.shape != (300,) or not np.isfinite(scores).all():
        fail(f"predict() gave {scores.shape} with non-finite values")

    k = 10
    recs = rec.recommend(k=k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = rec.recommend(k=k)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    check_recommendations(recs, data, k, data.n_users)
    launches = flash_causal_attention.launches
    calls = 2 * len(data.test) + 1 + 2  # test() twice, predict(), recommend() twice
    check_launches("flash kernel", "checkpoint", launches, rec.model.num_blocks * calls)

    plain = SASRec(cfg.replace(model={"fused_attention": False})).load(CHECKPOINT, data)
    ref_scores = plain.predict(pairs)
    err = float(np.abs(scores - ref_scores).max())
    if err > 1e-4:
        fail(f"predict() differs from the plain path by {err}")
    differ = same_top_k(recs, plain.recommend(k=k), k)
    log("serve", f"predict(300 pairs) max |d| vs plain {err:.3g}; recommend(k={k}) "
        f"{data.n_users} users, no train item, {differ} rows differ from plain at near-ties")
    n_eval = len(data.eval_candidates(data.test[0]).users)
    log("serve", f"test() {n_eval / test_s:.1f} users/s "
        f"({test_s * 1e3:.2f} ms); recommend() {data.n_users / rec_s:.1f} users/s "
        f"({rec_s * 1e3:.2f} ms)")
    log("serve", "test(): " + device_breakdown(rec.test))
    log("serve", "recommend(): " + device_breakdown(lambda: rec.recommend(k=k)))
    return launches


def serve_default_config(seed, root_dir, data):
    """Phase 7: configs/sasrec_default.json, random weights, ML-1M shape.
    Returns the flash kernel's launches in the timed recommend()."""
    cfg = load_config(DEFAULT_CONFIG).replace(system={"root_dir": root_dir})
    gen = torch.Generator().manual_seed(seed)
    rec = SASRec(cfg).init(data, gen)
    k = 10
    rec.recommend(users=np.arange(512), k=k, user_block=USER_BLOCK)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_causal_attention.launches = 0
    t0 = time.perf_counter()
    recs = rec.recommend(k=k, user_block=USER_BLOCK)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    launches = flash_causal_attention.launches
    n_calls = -(-data.n_users // USER_BLOCK)  # one scoring call per block of users
    check_launches("flash kernel", "default", launches, rec.model.num_blocks * n_calls)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_recommendations(recs, data, k, data.n_users)
    plain = SASRec(cfg.replace(model={"fused_attention": False}))
    plain.init(data, torch.Generator().manual_seed(seed))
    users = np.arange(256)
    differ = same_top_k(rec.recommend(users=users, k=k), plain.recommend(users=users, k=k), k)
    log("default", f"recommend(k={k}) {data.n_users} users, maxlen {rec.model.maxlen}: "
        f"{data.n_users / rec_s:.1f} users/s ({rec_s * 1e3:.2f} ms), peak memory "
        f"{peak_gib:.3f} GiB; first 256 users vs plain: {differ} rows differ at near-ties")
    log("default", "recommend(): " + device_breakdown(lambda: rec.recommend(k=k, user_block=USER_BLOCK)))
    return launches


def sasrec_config(seed, root_dir, **model):
    """The trained SASRec checkpoint's config (emb 64, 2 blocks, 2 heads,
    maxlen 100, batch 128, dropout 0.1, adam at lr 1e-3, early stop after 20
    epochs without gain, at most 200) on the structured split, one
    evaluation copy."""
    return load_config(CHECKPOINT).replace(system={"root_dir": root_dir, "seed": seed}, model=model)


def train_sasrec(phase, seed, root_dir, data, config=None, mesh_devices=None, **model):
    """Train SASRec through SASRec(cfg, mesh_devices=...).train(data) (``config``,
    else the checkpoint's with ``model`` over it); returns the recommender,
    the train result and the flash launches counted from 0 around train()
    alone: forward launches inside the epoch trainer's runs ("steps"), the
    other forward launches (the evaluations after each epoch, "eval") and
    backward launches ("bwd"), each checked against what the path needs (on
    a data axis of N, each of the N shards' steps and evaluations)."""
    rec = SASRec(config or sasrec_config(seed, root_dir, **model), mesh_devices=mesh_devices)
    counts = {"steps": 0}
    run = SequenceEpochTrainer.run

    def counted_run(trainer, generator):
        before = flash_causal_attention.launches
        loss = run(trainer, generator)
        counts["steps"] += flash_causal_attention.launches - before
        return loss

    SequenceEpochTrainer.run = counted_run
    flash_causal_attention.launches = flash_causal_attention_bwd.launches = 0
    try:
        result = rec.train(data)
        torch.cuda.synchronize()
    finally:
        SequenceEpochTrainer.run = run
    counts["eval"] = flash_causal_attention.launches - counts["steps"]
    counts["bwd"] = flash_causal_attention_bwd.launches
    engine, blocks = rec.engine, rec.model.num_blocks
    epochs = len(engine.bookkeeper.history)
    n_data = engine.mesh.shape["data"] if engine.mesh is not None else 1
    shards = n_data if engine.epoch_fn.dp.mode == "data" else 1  # the data shards' own steps
    steps = epochs * engine.epoch_fn.num_batches
    evaluators = (engine.valid_evaluator is not None) + (engine.test_evaluator is not None)
    check_launches("flash backward", phase, counts["bwd"], blocks * shards * steps)
    check_launches("flash forward in training steps", phase, counts["steps"], blocks * shards * steps)
    check_launches("flash forward in evaluations", phase, counts["eval"], blocks * n_data * evaluators * epochs)
    rates = RATES[phase] = [engine.epoch_fn.num_batches * engine.epoch_fn.batch_size / s
                            for s in engine.epoch_seconds]
    log(phase, f"{epochs} epochs of {engine.epoch_fn.num_batches} steps x {engine.epoch_fn.batch_size} sequences "
        f"(maxlen {rec.model.maxlen}, dh {rec.model.emb_dim // rec.model.num_heads}), best epoch "
        f"{result['best_epoch']}, train() {result['run_time']:.2f} s; sequences/s per epoch: "
        + ", ".join(f"{r:.0f}" for r in rates))
    if len(rates) > 1:
        log(phase, f"sequences/s after the first epoch: median {np.median(rates[1:]):.1f}, "
            f"min {min(rates[1:]):.1f}, max {max(rates[1:]):.1f}")
    return rec, result, counts


def check_sasrec_serving(phase, rec, data, ckpt_dir):
    """test(), predict() and recommend(k=10) of a trained SASRec, as phase 6
    checks them: well-formed, and against the plain path loaded from the
    port-trained checkpoint. Returns the test() row."""
    res = rec.test()
    if not all(np.isfinite(res[key]) for key in EXPECTED_METRICS):
        fail(f"{phase}: test() gave non-finite metrics {res}")
    pairs = {c: data.test[0][c][:300] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    scores = rec.predict(pairs)
    if scores.shape != (300,) or not np.isfinite(scores).all():
        fail(f"{phase}: predict() gave {scores.shape} with non-finite values")
    k = 10
    recs = rec.recommend(k=k)
    torch.cuda.synchronize()
    check_recommendations(recs, data, k, data.n_users)
    plain = SASRec(rec.config.replace(model={"fused_attention": False})).load(ckpt_dir, data)
    plain_res = plain.test()
    gap = max(abs(res[key] - plain_res[key]) for key in EXPECTED_METRICS)
    err = float(np.abs(scores - plain.predict(pairs)).max())
    if gap > METRIC_TOL or err > 1e-4:
        fail(f"{phase}: the kernel path differs from the plain path: metrics by {gap}, predict() by {err}")
    differ = same_top_k(recs, plain.recommend(k=k), k)
    log(phase, "test() " + ", ".join(f"{key} {res[key]:.6f}" for key in EXPECTED_METRICS)
        + f" (plain path within {gap:.2g}); predict(300 pairs) max |d| vs plain {err:.3g}; recommend(k={k}) "
        f"{data.n_users} users, no train item, {differ} rows differ from plain at near-ties")
    return res


def same_sasrec_runs(phase, runs):
    """Fail unless two (recommender, train result) runs of SASRec left the
    same best and last parameters bit for bit, at the same best epoch and
    valid metric."""
    best = [rec.model.state_dict() for rec, _ in runs]
    last = [sasrec_params_from_jax(load_raw_checkpoint(os.path.join(r["model_save_dir"], "last"))["params"])
            for _, r in runs]
    same = (all(torch.equal(best[0][name], best[1][name]) for name in best[0])
            and all(torch.equal(last[0][name], last[1][name]) for name in last[0])
            and (runs[0][1]["best_epoch"], runs[0][1]["valid_metric"])
            == (runs[1][1]["best_epoch"], runs[1][1]["valid_metric"]))
    if not same:
        fail(f"{phase}: two trainings of one seed gave different parameters")


def sasrec_training(seed, root_dir):
    """Phase 8, the slice's main path: a training to early stop, then its
    first SASREC_REPEAT_EPOCHS epochs twice, bit for bit. Returns the flash
    launches ({"sasrec_train": counts, "sasrec_train_again": the repeats'})."""
    data = SequentialData(load_split_data(SPLIT, n_test=1))
    rec, result, counts = train_sasrec("sasrec-train", seed, root_dir, data)
    res = check_sasrec_serving("sasrec-train", rec, data, result["model_save_dir"])
    log("sasrec-train", in_band("best valid ndcg@10", result["valid_metric"], SASREC_BAND["valid"]) + "; "
        + in_band("test ndcg@10", res["ndcg@10"], SASREC_BAND["test"]))

    runs, again_counts = [], {}
    for _ in range(2):
        again, again_result, more = train_sasrec("sasrec-train-again", seed, root_dir, data,
                                                 max_epoch=SASREC_REPEAT_EPOCHS)
        runs.append((again, again_result))
        again_counts = {key: again_counts.get(key, 0) + value for key, value in more.items()}
    same_sasrec_runs("sasrec-train", runs)
    log("sasrec-train", f"two more trainings of seed {seed} for {SASREC_REPEAT_EPOCHS} epochs gave the same best "
        f"and last parameters bit for bit (best epoch {runs[0][1]['best_epoch']}, valid ndcg@10 "
        f"{runs[0][1]['valid_metric']:.6f})")
    log("sasrec-train", "one more epoch: " + device_breakdown(
        lambda: float(rec.engine.epoch_fn.run(rec.engine.generator)), top=8, kernel="flash_"))
    return {"sasrec_train": counts, "sasrec_train_again": again_counts}


def sasrec_shipped_shape(seed, root_dir, data, n_steps=20):
    """Phase 9: ``n_steps`` training steps at configs/sasrec_default.json's
    shapes (maxlen 200, emb 64, 2 heads, batch 128, lr 0.5 as shipped) over
    the MovieLens-1M-shaped data, after one warm-up step, through the flash
    kernels and again through the plain attention (``fused_attention``
    false: the same dropout masks, autograd through the softmax). The two
    mean losses must agree within ``SHIPPED_LOSS_TOL``. Returns the flash
    launches of the kernel path's counted steps."""
    device = torch.device("cuda")

    def start(fused):
        cfg = load_config(DEFAULT_CONFIG).replace(system={"root_dir": root_dir, "seed": seed},
                                                  model={"fused_attention": fused})
        model = build_model(cfg.model, data.n_users, data.n_items, device=device)
        engine = TrainEngine(cfg, device).build(model, data)
        trainer = engine.epoch_fn
        batches = trainer.form(engine.generator)
        if trainer.num_batches < n_steps + 1:
            fail(f"the shipped shape has {trainer.num_batches} batches an epoch, fewer than {n_steps + 1}")
        trainer.run_batches(*(b[:1] for b in batches), generator=engine.generator)
        torch.cuda.synchronize()
        return cfg, model, trainer, lambda: float(trainer.run_batches(*(b[1:n_steps + 1] for b in batches),
                                                                      generator=engine.generator))

    cfg, model, trainer, steps = start(True)
    torch.cuda.reset_peak_memory_stats()
    flash_causal_attention.launches = flash_causal_attention_bwd.launches = 0
    t0 = time.perf_counter()
    loss = steps()
    secs = time.perf_counter() - t0
    counts = {"steps": flash_causal_attention.launches, "bwd": flash_causal_attention_bwd.launches}
    check_launches("flash forward in training steps", "shipped", counts["steps"], model.num_blocks * n_steps)
    check_launches("flash backward", "shipped", counts["bwd"], model.num_blocks * n_steps)
    if not np.isfinite(loss):
        fail(f"the shipped shape's mean loss over {n_steps} steps is {loss}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    plain_loss = start(False)[3]()
    log("shipped", f"{n_steps} steps x {trainer.batch_size} sequences (maxlen {model.maxlen}, {data.n_items} items, "
        f"lr {cfg.model.lr}): mean loss {loss:.4f} (plain attention {plain_loss:.4f}), "
        f"{n_steps * trainer.batch_size / secs:.1f} sequences/s ({secs * 1e3 / n_steps:.2f} ms a step), "
        f"peak memory {peak_gib:.3f} GiB")
    if not abs(loss / plain_loss - 1) <= SHIPPED_LOSS_TOL:
        fail(f"the shipped shape's mean loss {loss:.4f} through the kernels is more than {SHIPPED_LOSS_TOL:.0%} "
             f"from the plain attention's {plain_loss:.4f}")
    return counts


def sasrec_head_dims(seed, root_dir):
    """Phase 10: two epochs of training and a test() at head dims 16 (emb 32,
    2 heads) and 64 (emb 64, 1 head), each kernel's other instantiations.
    Returns their flash launches."""
    data = SequentialData(load_split_data(SPLIT, n_test=1))
    out = {}
    for name, model in (("dh16", {"emb_dim": 32, "num_heads": 2}), ("dh64", {"num_heads": 1})):
        rec, result, out[name] = train_sasrec(name, seed, root_dir, data, max_epoch=2, **model)
        res = rec.test()
        if not all(np.isfinite(res[key]) for key in EXPECTED_METRICS):
            fail(f"{name}: test() gave non-finite metrics {res}")
        log(name, "test() " + ", ".join(f"{key} {res[key]:.6f}" for key in EXPECTED_METRICS))
    return out


# -- the ring all-gather and row-sharded MF training (phases 11-14) -------------


def ring_bound(n, c, d, dtype, across):
    """(bound_ms, "bytes") of one all-gather of n (c, d) blocks. Across cards
    each card reads its block, writes n blocks to its HBM and receives n-1
    over NVLink, all cards at once; in loopback one card reads n blocks and
    writes n * n."""
    block = c * d * torch.empty((), dtype=dtype).element_size()
    if across:
        secs = max((1 + n) * block / HBM_BYTES_PER_S, (n - 1) * block / NVLINK_BYTES_PER_S)
    else:
        secs = (n + n * n) * block / HBM_BYTES_PER_S
    return secs * 1e3, "bytes"


def sync_all(devices):
    for device in set(devices):
        torch.cuda.synchronize(device)


def wall_ms(fn, devices, reps=20, warmup=3):
    """Mean milliseconds of ``fn`` across several cards: host clock around
    ``reps`` back-to-back calls, every card synchronised before and after."""
    for _ in range(warmup):
        fn()
    sync_all(devices)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_all(devices)
    return (time.perf_counter() - t0) * 1e3 / reps


def compare_ring(devices, c, d=64, dtype=torch.float32, timed=False, reps=100):
    """The all-gather kernel (the copy kernel in loopback, the one-shot
    kernel across cards) against its plain version, bit for bit: ``reps``
    calls back to back on new inputs each (the flags' epochs across cards),
    every 10th output and the last held against the inputs after one
    synchronisation. Returns a row; with ``timed`` also the times of a call
    (CUDA events in loopback, host clock around synchronised cards across
    them), of the kernel on the device (``queued_ms``), of the plain version and of the
    library yardstick (``torch.stack`` on each rank in loopback,
    ``torch.cuda.nccl.all_gather`` across cards)."""
    n = len(devices)
    across = len(set(devices)) > 1
    gen = torch.Generator().manual_seed(n * 100_000 + c)
    blocks = [torch.randn(c, d, generator=gen).to(dtype).to(dev) for dev in devices]
    inputs = [[b + k for b in blocks] for k in range(reps)]
    sync_all(devices)
    kept = {}
    for k, xs in enumerate(inputs):
        outs = ring_allgather(xs)
        if k % 10 == 0 or k == reps - 1:
            kept[k] = outs
    want = ring_allgather_reference(blocks)
    sync_all(devices)
    row = {"n": n, "shape": [c, d], "dtype": str(dtype).replace("torch.", ""), "across": across,
           "design": "one-shot" if across else "loopback copy", "calls": reps, "max_abs_err": 0.0}
    for k, outs in kept.items():
        for out, x in zip(outs, inputs[k]):
            full = torch.stack([y.to(out.device) for y in inputs[k]])
            row["max_abs_err"] = max(row["max_abs_err"], float((out.float() - full.float()).abs().max()))
            if not torch.equal(out, full):
                fail(f"ring_allgather call {k} differs from its inputs: {row}")
    got = kept[0]
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"ring_allgather differs from its plain version: {row}")
    if timed:
        outs = [torch.empty((n, c, d), dtype=dtype, device=dev) for dev in devices]
        if across:
            row["ms"] = wall_ms(lambda: ring_allgather(blocks), devices)
            row["plain_ms"] = wall_ms(lambda: ring_allgather_reference(blocks), devices)
            row["library"] = "torch.cuda.nccl.all_gather"
            try:
                row["library_ms"] = wall_ms(lambda: torch.cuda.nccl.all_gather(blocks, outs), devices)
            except RuntimeError as err:  # a yardstick only: its absence fails nothing
                log("ring", f"torch.cuda.nccl.all_gather failed, library_ms not measured: {err}")
                row["library_ms"] = None
        else:
            row["ms"] = cuda_ms(lambda: ring_allgather(blocks))
            row["plain_ms"] = cuda_ms(lambda: ring_allgather_reference(blocks))
            row["library"] = "torch.stack on each rank"
            row["library_ms"] = cuda_ms(lambda: [torch.stack(blocks, out=o) for o in outs])
        row["device_ms"] = queued_ms(lambda: ring_allgather(blocks), devices)
        row["bound_ms"], row["bound_by"] = ring_bound(n, c, d, dtype, across)
        library = "not measured" if row["library_ms"] is None else f"{row['library_ms'] * 1e3:.2f} us"
        log("ring", f"n {n} x ({c}, {d}) {row['dtype']} {row['design']}: call {row['ms'] * 1e3:.2f} us, on the "
            f"device {row['device_ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us, "
            f"{row['library']} {library}, bound {row['bound_ms'] * 1e3:.3f} us by bytes")
    return row


def ring_phase(devices_for, timed_shapes):
    """Phase 11 (12 across cards): the kernel at n 2/3/4/8 (what
    ``devices_for`` gives) x C 8/200/400/800/8192 x d 64 float32 and one
    bfloat16 case, the timed ``(n, c)`` shapes, and the device time each
    rank adds, from the device times of C 8 blocks at the fewest and the
    most ranks. Returns the rows."""
    rows = []
    for n in RING_NS:
        devices = devices_for(n)
        if devices is None:
            continue
        for c in RING_CS:
            rows.append(compare_ring(devices, c, timed=(n, c) in timed_shapes))
    rows.append(compare_ring(devices_for(4), 200, dtype=torch.bfloat16))
    for row in rows:
        log("ring", json.dumps(row))
    tiny = {n: compare_ring(devices_for(n), 8, timed=True, reps=1) for n in RING_NS if devices_for(n) is not None}
    lo, hi = min(tiny), max(tiny)
    rank_us = (tiny[hi]["device_ms"] - tiny[lo]["device_ms"]) * 1e3 / (hi - lo)
    for row in rows:
        row["rank_us"] = rank_us
    log("ring", f"device time a rank adds: ({tiny[hi]['device_ms'] * 1e3:.2f} - {tiny[lo]['device_ms'] * 1e3:.2f} us)"
        f" / {hi - lo} ranks = {rank_us:.2f} us (C 8, n {hi} and {lo})")
    log("ring", f"{len(rows)} cases x 100 back-to-back calls: every output bit-equal to its inputs and to the "
        "plain version")
    return rows


def mesh_config(seed, root_dir, mesh_shape, **model):
    """The slice: configs/mf_default.json with lazy Adam and the ring lookup
    on a ("data", "model") mesh."""
    return mf_config(seed, root_dir, sparse_optim=True, lookup_strategy="ring",
                     capacity_factor=MESH_CAPACITY_FACTOR, **model).replace(
        system={"mesh": {"data": mesh_shape[0], "model": mesh_shape[1]}})


def check_sharded_counts(path, trainer, calls, launches, steps):
    """Exact ring counts (2 row tables x data rows x steps; one launch a call
    and card of the ring), and no bucket overflow."""
    expected = 2 * trainer.n_data * steps
    check_launches("ring_allgather calls", path, calls, expected)
    check_launches("ring_allgather", path, launches, expected * len(set(trainer.mesh.devices[0])))
    dropped, overflow = int(trainer.dropped), int(trainer.lookup_overflow)
    if dropped or overflow:
        fail(f"{path}: the bucketed exchange dropped {dropped} gradient rows, the ring lookup overflowed "
             f"{overflow} batch positions")


def mesh_entry_point(seed, root_dir, mesh_shape, devices, epochs=3):
    """Phase 13 (the slice's main path): MatrixFactorization(cfg, mesh_devices)
    .train(data) for ``epochs`` epochs, held bit for bit against the one-device
    lazy-Adam trainer ("xla") through the same entry point, seed and batches:
    on a (1, n) mesh every lookup copies rows and every sum over the mesh
    meets zeros only. Then test() and recommend(). Returns the ring launches
    of train()."""
    path = f"mf-mesh-{mesh_shape[0]}x{mesh_shape[1]}"
    data = mf_split()
    ref = MatrixFactorization(mf_config(seed, root_dir, sparse_optim=True, row_update="xla", max_epoch=epochs))
    ref_result = ref.train(data)
    rec = MatrixFactorization(mesh_config(seed, root_dir, mesh_shape, max_epoch=epochs), mesh_devices=devices)
    ring_allgather.calls = ring_allgather.launches = 0
    result = rec.train(data)
    sync_all(devices)
    calls, launches = ring_allgather.calls, ring_allgather.launches
    trainer = rec.engine.epoch_fn
    steps = epochs * trainer.num_batches
    check_sharded_counts(path, trainer, calls, launches, steps)
    history = [h["valid"] for h in rec.engine.bookkeeper.history]
    if history != [h["valid"] for h in ref.engine.bookkeeper.history]:
        fail(f"{path}: validation metrics differ from the one-device trainer's")
    for (name, p), q in zip(ref.model.named_parameters(), rec.model.parameters()):
        if not torch.equal(p, q):
            fail(f"{path}: best {name} differs from the one-device trainer's by {float((p - q).abs().max())}")
    for name, (m, v) in trainer.state["moments"].items():
        want_m, want_v = ref.engine.epoch_fn.state["moments"][name]
        n_rows = want_m.shape[0]
        if not (torch.equal(m[:n_rows], want_m) and torch.equal(v[:n_rows], want_v)) or m[n_rows:].any():
            fail(f"{path}: {name} moments differ from the one-device trainer's")
    rates = [trainer.padded_size / s for s in rec.engine.epoch_seconds]
    log(path, f"{epochs} epochs of {trainer.num_batches} steps x {trainer.batch_size} on {devices}: tables, "
        f"moments and every validation bit-equal to the one-device trainer (best valid ndcg@10 "
        f"{result['valid_metric']:.6f}); examples/s per epoch " + ", ".join(f"{r:.0f}" for r in rates)
        + f" (one device: " + ", ".join(f"{ref.engine.epoch_fn.padded_size / s:.0f}" for s in ref.engine.epoch_seconds)
        + ")")
    res = rec.test()
    if not all(np.isfinite(res[key]) for key in EXPECTED_MF_METRICS):
        fail(f"{path}: test() gave non-finite metrics {res}")
    recs = rec.recommend(k=10)
    check_recommendations(recs, data, 10, data.n_users)
    if int(recs[DEFAULT_ITEM_COL].max()) >= data.n_items:
        fail(f"{path}: recommend() ranked a pad item")
    padded = trainer.padded_params()["item_emb"].shape[0]
    log(path, "test() " + ", ".join(f"{k} {res[k]:.6f}" for k in EXPECTED_MF_METRICS)
        + f"; recommend(k=10) {data.n_users} users, no train item, no pad item (item table padded "
        f"{data.n_items} -> {padded} rows)")
    log(path, f"{PROFILED_STEPS} more steps: " + profile_steps(trainer, rec.engine.generator))
    return launches


def profile_steps(trainer, generator):
    """``device_breakdown`` of PROFILED_STEPS sharded steps (a whole epoch
    is ~600,000 device activities, which the profiler takes minutes over)."""
    users, pos, neg = (x[:PROFILED_STEPS] for x in trainer.form(generator))
    return device_breakdown(lambda: float(trainer.run_batches(users, pos, neg)), top=8,
                            kernel="ring_allgather")


def well_conditioned(model, seed):
    """The MF trainer tests' parameters: embeddings of scale 1, biases 0.5 x
    N(0, 1), global bias 0.3, so every gradient lies well above its rounding."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = 1.0 if p.dim() == 2 else 0.5
            p.copy_(scale * torch.randn(p.shape, generator=gen) if p.dim() else torch.tensor(0.3))
    return model


def mesh_run_batches(seed, mesh_shape, devices, epochs=3):
    """Phase 14: ``epochs`` epochs of the sharded trainer through run_batches
    on a mesh with a data axis, against the one-device lazy-Adam trainer on
    the same batches from the same well-conditioned weights, within MESH_TOL
    (see there). Returns the ring launches."""
    path = f"mf-mesh-{mesh_shape[0]}x{mesh_shape[1]}"
    data = mf_split()
    cfg = mesh_config(seed, "unused", mesh_shape).model
    models = [well_conditioned(build_model(cfg, data.n_users, data.n_items, device=devices[0]), seed)
              for _ in range(2)]
    neg = make_negative_sampler(data, device=devices[0])
    ref = SparseEpochTrainer(models[0], data.train_arrays(), cfg.batch_size, neg, cfg.lr,
                             make_optimizer(cfg, [models[0].global_bias]), row_update="xla")
    trainer = ShardedSparseEpochTrainer(
        models[1], data.train_arrays(), cfg.batch_size, neg, cfg.lr, make_mesh(*mesh_shape, devices),
        lambda params: make_optimizer(cfg, params), lookup_strategy="ring",
        grad_exchange="bucketed" if mesh_shape[1] >= 4 else "allgather", capacity_factor=cfg.capacity_factor)
    gen = torch.Generator(device=devices[0]).manual_seed(seed)
    calls = launches = 0
    worst = []
    for epoch, limit in zip(range(epochs), MESH_TOL):
        batches = ref.form(gen)
        want = float(ref.run_batches(*batches))
        ring_allgather.calls = ring_allgather.launches = 0
        got = float(trainer.run_batches(*batches))
        sync_all(devices)
        calls, launches = calls + ring_allgather.calls, launches + ring_allgather.launches
        trainer.assemble()
        errs = {"loss": abs(got - want) / abs(want)}
        for (name, p), q in zip(models[0].named_parameters(), models[1].parameters()):
            errs[name] = float(((p - q).detach().abs() / p.detach().abs().clamp(min=1)).max())
        for name, pair in ref.state["moments"].items():
            for i, want_x in enumerate(pair):
                got_x = trainer.state["moments"][name][i][: want_x.shape[0]]
                errs[f"{name}.{'mv'[i]}"] = float((got_x - want_x).abs().max() / want_x.abs().max())
        worst.append(max(errs.values()))
        if errs["loss"] > 1e-5 or worst[-1] > limit:
            fail(f"{path} epoch {epoch}: differs from the one-device trainer beyond {limit}: {errs}")
    check_sharded_counts(path, trainer, calls, launches, epochs * trainer.num_batches)
    log(path, f"{epochs} epochs through run_batches on {devices}: within {MESH_TOL} of the one-device trainer "
        f"(largest relative |d| per epoch: " + ", ".join(f"{w:.3g}" for w in worst) + ")")
    return launches


def mesh_table_scale(seed, devices, n_steps=20, n_rows=1_000_000, batch=16_384):
    """Phase 15: ``n_steps`` steps on a (1, 4) mesh with 1,000,000-row user
    and item tables (d 64) and batches of 16,384 uniform ids: C 8,192 a shard
    for the users, at the default capacity_factor 2. Time a step, the ring's
    share of device time, and the overflow counts. Returns the ring launches."""
    rng = np.random.default_rng(seed)
    total = batch * (n_steps + 1)
    arrays = types.SimpleNamespace(users=rng.integers(0, n_rows, total), items=rng.integers(0, n_rows, total))
    cfg = mf_config(seed, "unused").model
    model = build_model(cfg, n_rows, n_rows, device=devices[0]).init_weights(torch.Generator().manual_seed(seed))

    def uniform(gen, users, shape):
        return torch.randint(0, n_rows, shape, generator=gen, device=users.device)

    trainer = ShardedSparseEpochTrainer(model, arrays, batch, uniform, cfg.lr, make_mesh(1, 4, devices),
                                        lambda params: make_optimizer(cfg, params), lookup_strategy="ring",
                                        grad_exchange="bucketed")
    users, pos, neg = trainer.form(torch.Generator(device=devices[0]).manual_seed(seed))
    trainer.run_batches(users[:1], pos[:1], neg[:1])  # warm-up
    sync_all(devices)
    ring_allgather.calls = ring_allgather.launches = 0
    t0 = time.perf_counter()
    loss = float(trainer.run_batches(users[1:], pos[1:], neg[1:]))
    secs = time.perf_counter() - t0
    launches = ring_allgather.launches
    check_sharded_counts("table-scale", trainer, ring_allgather.calls, launches, n_steps)
    if not np.isfinite(loss):
        fail(f"table-scale: mean loss {loss}")
    log("table-scale", f"{n_steps} steps x {batch} on {n_rows} x 64 tables, (1, 4) mesh of {devices}: "
        f"{secs * 1e3 / n_steps:.2f} ms a step ({n_steps * batch / secs:.1f} examples/s), loss {loss:.4f}, "
        f"0 dropped, 0 overflowed (ring bucket C {trainer._capacity_for(batch)})")
    log("table-scale", "two steps: " + device_breakdown(
        lambda: float(trainer.run_batches(users[1:3], pos[1:3], neg[1:3])), top=8, kernel="ring_allgather"))
    return launches


def four_card_training(seed, root_dir, devices):
    """Phase 16 (4 cards): the slice to early stop on a real (1, 4) mesh:
    inside the JAX package's ten-seed lazy-Adam band, nothing dropped."""
    data = mf_split()
    rec = MatrixFactorization(mesh_config(seed, root_dir, (1, 4)), mesh_devices=devices)
    ring_allgather.calls = ring_allgather.launches = 0
    result = rec.train(data)
    sync_all(devices)
    trainer = rec.engine.epoch_fn
    steps = len(rec.engine.bookkeeper.history) * trainer.num_batches
    check_sharded_counts("mf-mesh-4-cards", trainer, ring_allgather.calls, ring_allgather.launches, steps)
    launches = ring_allgather.launches
    res = rec.test()
    rates = [trainer.padded_size / s for s in rec.engine.epoch_seconds]
    log("mf-mesh-4-cards", f"{len(rates)} epochs, best epoch {result['best_epoch']}, train() "
        f"{result['run_time']:.2f} s; examples/s after the first epoch: median {np.median(rates[1:]):.1f}; "
        f"best valid ndcg@10 {result['valid_metric']:.6f}, test ndcg@10 {res['ndcg@10']:.6f}")
    log("mf-mesh-4-cards", f"{PROFILED_STEPS} more steps: " + profile_steps(trainer, rec.engine.generator))
    log("mf-mesh-4-cards", in_band("best valid ndcg@10", result["valid_metric"], SPARSE_BAND["valid"]) + "; "
        + in_band("test ndcg@10", res["ndcg@10"], SPARSE_BAND["test"]))
    return launches


def sharded_phases(seed, root_dir, cards_only=False, ring_only=False):
    """Phases 11-16; with ``cards_only`` on 4 cards, the one-card training
    phases (13-15 on cuda:0) are left out; with ``ring_only``, every training
    phase. Returns (kernel-check rows, ring launches by path)."""
    n_cards = torch.cuda.device_count()
    one_card = ["cuda:0"] * 4
    rows = ring_phase(lambda n: ["cuda:0"] * n, {(4, 200), (4, 800), (4, 8192)})
    launches = {}
    if not ring_only and not (cards_only and n_cards >= 4):
        launches["mf_mesh_1x4"] = mesh_entry_point(seed, root_dir, (1, 4), one_card, ONE_CARD_MESH_EPOCHS)
        launches["mf_mesh_2x2"] = mesh_run_batches(seed, (2, 2), one_card, ONE_CARD_MESH_EPOCHS)
        launches["table_scale"] = mesh_table_scale(seed, one_card)
    if n_cards >= 4:
        cards = [f"cuda:{i}" for i in range(4)]
        topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True, timeout=60)
        print(topo.stdout or f"nvidia-smi topo -m: exit {topo.returncode} {topo.stderr.strip()}", flush=True)
        access = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
                  for i in range(n_cards) for j in range(n_cards) if i != j}
        log("4-cards", f"peer access: {access}")
        rows += ring_phase(lambda n: cards[:n] if n <= 4 else None, {(4, 200), (4, 800), (4, 8192)})
        if ring_only:
            return rows, launches
        launches["mf_mesh_1x4_cards"] = mesh_entry_point(seed, root_dir, (1, 4), cards)
        launches["mf_mesh_2x2_cards"] = mesh_run_batches(seed, (2, 2), cards)
        launches["mf_mesh_4_cards_training"] = four_card_training(seed, root_dir, cards)
    return rows, launches


def ring_entry(rows, launches):
    """The all-gather's line of the kernels JSON: times at the path's
    user-table shape in loopback (n 4, C 200 is the bucket of user_emb's 400
    ids at capacity_factor 2; 800 that of item_emb at MESH_CAPACITY_FACTOR),
    and every timed row ("loopback copy" or "one-shot")."""
    timed = [r for r in rows if "ms" in r and r["calls"] > 1]
    main_row = next(r for r in timed if not r["across"] and r["n"] == 4 and r["shape"][0] == 200)
    return {
        "name": "ring_allgather",
        "route": "cuda",
        "source": "beta_recsys_tpu_torch/csrc/ring_allgather.cu",
        "replaces": "beta_recsys_tpu/ops/pallas/ring_exchange.py:41",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library": main_row["library"],
        "device_ms": main_row["device_ms"],
        "rank_us": main_row.get("rank_us"),
        "design": main_row["design"],
        "shape": [main_row["n"], *main_row["shape"]],
        "dtype": main_row["dtype"],
        "timed": [{k: r.get(k) for k in ("n", "shape", "across", "design", "ms", "device_ms",
                                         "plain_ms", "bound_ms", "bound_by", "library", "library_ms", "rank_us")}
                  for r in timed],
    }


# -- the NCF family (phases 17-19) ------------------------------------------------


def zero_kernel_counts():
    flash_causal_attention.launches = flash_causal_attention_bwd.launches = 0
    fused_rowadam.launches = ring_allgather.launches = 0
    fused_rowadam_packed.launches = fused_rowadam_packed_bf16.launches = 0


def kernel_counts():
    """Each kernel's launches since the counts were last set to 0."""
    return {"flash_causal_attention_fwd": flash_causal_attention.launches,
            "flash_causal_attention_bwd": flash_causal_attention_bwd.launches,
            "fused_rowadam": fused_rowadam.launches, "ring_allgather": ring_allgather.launches,
            "fused_rowadam_packed": fused_rowadam_packed.launches,
            "fused_rowadam_packed_bf16": fused_rowadam_packed_bf16.launches}


def check_no_kernel(path):
    """The NCF family's and the graph models' paths run no hand-written
    kernel: the JAX package trains and serves them through XLA code alone.
    Returns each kernel's count (all 0)."""
    torch.cuda.synchronize()
    counts = kernel_counts()
    if any(counts.values()):
        fail(f"{path}: the path launched kernels {counts}, expected none")
    return counts


def shipped_config(path, seed, root_dir, **model):
    """The shipped config at ``path`` on the structured synthetic split, one
    evaluation copy, as the JAX package's parity runs train it."""
    return load_config(os.path.join(REPO, path)).replace(
        system={"root_dir": root_dir, "seed": seed},
        dataset={"dataset": "synthetic_structured", "n_test": 1},
        model=model,
    )


def ncf_config(name, seed, root_dir):
    return shipped_config(NCF_FAMILY[name][1], seed, root_dir, max_epoch=NCF_EPOCHS)


def serve_ncf_checkpoints(root_dir):
    """Phase 17: each checkpoint's load, test(), predict() and recommend(),
    with no kernel launched."""
    data = mf_split()
    for name, (cls, _, checkpoint) in NCF_FAMILY.items():
        path = os.path.join(REPO, "parity_runs/checkpoints", checkpoint)
        phase = f"{name.lower()}-serve"
        cfg = load_config(path).replace(system={"root_dir": root_dir})
        zero_kernel_counts()
        rec = cls(cfg).load(path, data)
        res = rec.test()
        for key, want in EXPECTED_NCF_METRICS[name].items():
            if abs(res[key] - want) > METRIC_TOL:
                fail(f"{name} checkpoint test() {key} = {res[key]:.6f}, expected {want} +- {METRIC_TOL}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.test()
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        pairs = {c: data.test[0][c][:300] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
        scores = rec.predict(pairs)
        if scores.shape != (300,) or not np.isfinite(scores).all() or (scores < 0).any() or (scores > 1).any():
            fail(f"{phase}: predict() gave {scores.shape} scores outside [0, 1] or non-finite")
        k = 10
        rec.recommend(k=k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = rec.recommend(k=k)
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        check_recommendations(recs, data, k, data.n_users)
        check_no_kernel(phase)
        plain = cls(cfg, device="cpu").load(path, data)
        differ = same_top_k(recs, plain.recommend(k=k), k)
        err = float(np.abs(scores - plain.predict(pairs)).max())
        if err > 1e-4:
            fail(f"{phase}: predict() differs from the CPU's by {err}")
        n_eval = len(data.eval_candidates(data.test[0]).users)
        log(phase, "test() " + ", ".join(f"{key} {res[key]:.6f}" for key in EXPECTED_NCF_METRICS[name])
            + f" (expected to {METRIC_TOL}); predict(300 pairs) in [0, 1], max |d| vs the CPU {err:.3g}; "
            f"recommend(k={k}) {data.n_users} users, no train item, {differ} rows differ from the CPU's at "
            "near-ties; no kernel launched")
        log(phase, f"test() {n_eval / test_s:.1f} users/s ({test_s * 1e3:.2f} ms); recommend() "
            f"{data.n_users / rec_s:.1f} users/s ({rec_s * 1e3:.2f} ms)")
        log(phase, "recommend(): " + device_breakdown(lambda: rec.recommend(k=k)))


def train_pointwise(name, phase, seed, root_dir, data, rec=None):
    """Train ``name`` at its shipped config through XRecommender(cfg)
    .train(data) (or through ``rec``, a recommender built for it), with no
    kernel launched; returns the recommender, the train result and the test()
    row."""
    rec = rec or NCF_FAMILY[name][0](ncf_config(name, seed, root_dir))
    zero_kernel_counts()
    result = rec.train(data)
    res = rec.test()
    check_no_kernel(phase)
    engine = rec.engine
    trainer = engine.epoch_fn
    rates = [trainer.padded_size / s for s in engine.epoch_seconds]
    log(phase, f"{len(rates)} epochs of {trainer.num_batches} steps x {trainer.batch_size} positives + "
        f"{trainer.batch_size * trainer.num_neg} negatives, best epoch {result['best_epoch']}, train() "
        f"{result['run_time']:.2f} s; examples/s (positives) per epoch: " + ", ".join(f"{r:.0f}" for r in rates))
    if len(rates) > 1:
        log(phase, f"examples/s after the first epoch: median {np.median(rates[1:]):.1f}, "
            f"min {min(rates[1:]):.1f}, max {max(rates[1:]):.1f} ({1 + trainer.num_neg} rows an example)")
    log(phase, f"best valid ndcg@10 {result['valid_metric']:.6f}; test() "
        + ", ".join(f"{k} {res[k]:.6f}" for k in EXPECTED_NCF_METRICS[name]))
    return rec, result, res


def train_ncf_family(seed, root_dir, data):
    """Phase 18. Returns the trained MLP recommender."""
    out = {}
    for name in NCF_FAMILY:
        phase = f"{name.lower()}-train"
        rec, result, res = train_pointwise(name, phase, seed, root_dir, data)
        band = NCF_BANDS[name]
        log(phase, f"(cap {NCF_EPOCHS} epochs) " + in_band("best valid ndcg@10", result["valid_metric"], band["valid"])
            + "; " + in_band("test ndcg@10", res["ndcg@10"], band["test"]))
        check_mf_serving(phase, rec)
        log(phase, f"{PROFILED_WINDOW} more steps: " + profile_window(rec.engine.epoch_fn, rec.engine.generator,
                                                                        top=8))
        rec.model.load_trimmed(rec.params_from_jax(rec.engine.load_params()))  # the best again
        out[name] = (rec, result)
    repeats_bit_for_bit("NCF", "ncf-train", seed, REPEAT_EPOCHS, lambda p, epochs: (*train_pointwise(
        "NCF", p, seed, root_dir, data, NeuCF(ncf_config("NCF", seed, root_dir).replace(model={"max_epoch": epochs}))),
        None), ncf_params_from_jax)
    return out["MLP"][0]


def warm_started_ncf(seed, root_dir, data, mlp):
    """Phase 19: NeuCF(cfg, gmf_params, mlp_params).train(data) from the
    port's trees of phase 18's MLP and of a GMF trained at NCF's emb_dim
    (NeuMF's GMF tower is emb_dim wide, as in the reference's pretraining).
    The weights training starts from are read as ``init_weights`` leaves
    them."""
    # Neither training holds a band: the pretraining is capped at
    # GMF_PRETRAIN_EPOCHS (it ran 103 epochs to early stop) and NeuMF at
    # NCF_WARM_EPOCHS (its best epoch was 3 of 24) to keep the script's time.
    cfg = ncf_config("NCF", seed, root_dir).replace(model={"max_epoch": NCF_WARM_EPOCHS})
    gmf_cfg = ncf_config("GMF", seed, root_dir).replace(model={"emb_dim": cfg.model.emb_dim,
                                                              "max_epoch": GMF_PRETRAIN_EPOCHS})
    gmf, _, _ = train_pointwise("GMF", "gmf-pretrain", seed, root_dir, data, GMFRecommender(gmf_cfg))
    gmf_params, mlp_params = (nest_dotted(r.model.state_dict()) for r in (gmf, mlp))
    rec = NeuCF(cfg, gmf_params=gmf_params, mlp_params=mlp_params)
    start = {}
    init = NeuMF.init_weights

    def kept(model, generator):
        init(model, generator)
        start.update({key: value.clone() for key, value in model.state_dict().items()})
        return model

    NeuMF.init_weights = kept
    try:
        _, result, res = train_pointwise("NCF", "ncf-warm", seed, root_dir, data, rec)
    finally:
        NeuMF.init_weights = init
    given = {f"{side}_emb_gmf": gmf_params[f"{side}_emb"] for side in ("user", "item")}
    given.update({f"{side}_emb_mlp": mlp_params[f"{side}_emb"] for side in ("user", "item")})
    given.update({f"layers.{i}.{leaf}": mlp_params["layers"][str(i)][leaf]
                  for i in range(len(rec.model.layers)) for leaf in ("w", "b")})
    for key, value in given.items():
        if not torch.equal(start[key], value):
            fail(f"ncf-warm: the initial {key} is not the pretrained one")
    if not all(np.isfinite(res[key]) for key in EXPECTED_NCF_METRICS["NCF"]):
        fail(f"ncf-warm: test() gave non-finite metrics {res}")
    log("ncf-warm", f"started from the pretrained GMF and MLP tables and layers bit for bit ({len(given)} "
        f"tensors); best valid ndcg@10 {result['valid_metric']:.6f}, test ndcg@10 {res['ndcg@10']:.6f}")


def ncf_phases(seed, root_dir):
    """Phases 17-19."""
    serve_ncf_checkpoints(root_dir)
    data = mf_split()
    warm_started_ncf(seed, root_dir, data, train_ncf_family(seed, root_dir, data))


# -- the graph models (phases 20-22) ----------------------------------------------


def graph_config(name, seed, root_dir, **model):
    return shipped_config(GRAPH_FAMILY[name][1], seed, root_dir, **model)


def graph_checkpoint(name):
    return os.path.join(REPO, "parity_runs/checkpoints", GRAPH_FAMILY[name][2])


def check_graph_serving(phase, rec):
    """recommend(k=10) for every user well-formed with no train item;
    predict() finite (NGCF's scores are raw dot products, not in [0, 1])."""
    k = 10
    recs = rec.recommend(k=k)
    torch.cuda.synchronize()
    check_recommendations(recs, rec.data, k, rec.data.n_users)
    pairs = {c: rec.data.test[0][c][:300] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    scores = rec.predict(pairs)
    if scores.shape != (300,) or not np.isfinite(scores).all():
        fail(f"{phase}: predict() gave {scores.shape} scores with non-finite values")
    log(phase, f"recommend(k={k}) {rec.data.n_users} users well-formed, no train item; predict(300 pairs) finite")


def sparse_route_repeats(prop, seed, d=64):
    """The sparse route's A @ x and its x-gradient A^T @ g, with the packed
    edge values and with dropped ones, each computed twice from the same
    inputs: {product: largest |difference|}, 0 where the two are bit-equal."""
    device = prop.vals.device
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(prop.n_nodes, d, generator=gen, device=device)
    g = torch.randn(prop.n_nodes, d, generator=gen, device=device)
    dropped = edge_dropout(gen, prop.vals, 0.6)
    outs = []
    for vals in (None, dropped, None, dropped):
        xr = x.clone().requires_grad_()
        y = prop.operator(vals)(xr)
        y.backward(g)
        outs += [y.detach(), xr.grad]
    names = ("A @ x", "A^T @ g", "A @ x (dropped edges)", "A^T @ g (dropped edges)")
    return {name: 0.0 if torch.equal(a, b) else float((a - b).abs().max())
            for name, a, b in zip(names, outs[:4], outs[4:])}


def propagation_times(dense, sparse, d=64):
    """One layer's A @ x at width ``d`` through each route beside the least
    time the card could take for it (HBM bytes: the route's A read once, x
    read and the output written once; float32 operations: 2 a stored entry
    and column), and the time a step takes to build each route's A from
    dropped edge values."""
    n, n_edges, device = dense.n_nodes, dense.vals.numel(), dense.vals.device
    x = torch.randn(n, d, device=device)
    vals = edge_dropout(torch.Generator(device=device).manual_seed(0), dense.vals, 0.6)
    parts = []
    for route, op, a_bytes, stored in (("dense", dense.operator(), 4 * n * n, n * n),
                                       ("CSR", sparse.operator(), 12 * n_edges + 8 * (n + 1), n_edges)):
        bound = max((a_bytes + 8 * n * d) / HBM_BYTES_PER_S, 2 * stored * d / PEAK_FLOPS[torch.float32]) * 1e3
        parts.append(f"{route} A @ x {cuda_ms(lambda: op(x)):.4f} ms (bound {bound:.4f})")
    parts.append(f"a step's A from dropped values: dense {cuda_ms(lambda: dense.operator(vals)):.4f} ms, "
                 f"CSR (A and A^T) {cuda_ms(lambda: sparse.operator(vals)):.4f} ms")
    return f"n {n}, {n_edges} edges, d {d}: " + "; ".join(parts)


def profiled_in_child(phases, seed):
    """Run ``chip_smoke.py --profile <phase> ...`` in one process of its own
    and print its lines: after the profiles of phases 1-19 in one process, a
    later profile has come back without CUDA events."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--profile", *phases, "--seed", str(seed)],
                         capture_output=True, text=True, timeout=900)
    for line in out.stdout.splitlines():
        print(f"    {line}", flush=True)
    if out.returncode:
        fail(f"{', '.join(phases)}: the profiling process exited {out.returncode}: {out.stderr[-3000:]}")


def serve_graph_checkpoints(root_dir, data):
    """Phase 20: each checkpoint's load, test(), predict() and recommend()
    against the JAX package's metrics and the port on the CPU, and LightGCN's
    test() through the sparse route. Returns the kernels' counts by path."""
    counts, dense_res, served = {}, {}, {}
    for name, (cls, _, _) in GRAPH_FAMILY.items():
        path = graph_checkpoint(name)
        phase = f"{name.lower()}-serve"
        cfg = load_config(path).replace(system={"root_dir": root_dir})
        zero_kernel_counts()
        rec = served[name] = cls(cfg).load(path, data)
        res = dense_res[name] = rec.test()
        for key, want in EXPECTED_GRAPH_METRICS[name].items():
            if abs(res[key] - want) > METRIC_TOL:
                fail(f"{name} checkpoint test() {key} = {res[key]:.6f}, expected {want} +- {METRIC_TOL}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.test()
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        pairs = {c: data.test[0][c][:300] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
        scores = rec.predict(pairs)
        k = 10
        rec.recommend(k=k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = rec.recommend(k=k)
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        check_recommendations(recs, data, k, data.n_users)
        counts[phase] = check_no_kernel(phase)
        plain = cls(cfg, device="cpu").load(path, data)
        differ = same_top_k(recs, plain.recommend(k=k), k)
        err = float(np.abs(scores - plain.predict(pairs)).max())
        if err > PREDICT_TOL:
            fail(f"{phase}: predict() differs from the CPU's by {err}")
        n_eval = len(data.eval_candidates(data.test[0]).users)
        log(phase, "test() " + ", ".join(f"{key} {res[key]:.6f}" for key in EXPECTED_GRAPH_METRICS[name])
            + f" (expected to {METRIC_TOL}); predict(300 pairs) max |d| vs the CPU {err:.3g}; "
            f"recommend(k={k}) {data.n_users} users, no train item, {differ} rows differ from the CPU's at "
            "near-ties; no kernel launched")
        log(phase, f"test() {n_eval / test_s:.1f} users/s ({test_s * 1e3:.2f} ms); recommend() "
            f"{data.n_users / rec_s:.1f} users/s ({rec_s * 1e3:.2f} ms)")

    path = graph_checkpoint("LightGCN")
    cfg = load_config(path).replace(system={"root_dir": root_dir}, model={"graph_format": "chunked"})
    zero_kernel_counts()
    sparse = LightGCN(cfg).load(path, data)
    if sparse.model.prop.format != "csr":
        fail(f"graph_format 'chunked' packed a {sparse.model.prop.format!r} propagator")
    res = sparse.test()
    gap = max(abs(res[key] - dense_res["LightGCN"][key]) for key in res)
    if gap > SPARSE_ROUTE_TOL:
        fail(f"lightgcn-serve: test() through the sparse route differs from the dense route's by {gap}")
    repeats = sparse_route_repeats(sparse.model.prop, 0)
    counts["lightgcn-serve-sparse"] = check_no_kernel("lightgcn-serve-sparse")
    log("lightgcn-serve", f"sparse route (CSR both ways): test() within {gap:.3g} of the dense route's; computed "
        "twice, " + ", ".join(f"{name} {'bit for bit alike' if not d else f'differs by up to {d:.3g}'}"
                              for name, d in repeats.items()))
    log("lightgcn-serve", propagation_times(served["LightGCN"].model.prop, sparse.model.prop))
    return counts


def train_dense(rec, phase, data):
    """Train ``rec`` (a recommender on a trainer with no kernel) through
    rec.train(data); returns the recommender, the train result, the test()
    row and the kernels' counts around the path. Logs each epoch's rate and
    test()'s time and peak device memory."""
    zero_kernel_counts()
    result = rec.train(data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = rec.test()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = check_no_kernel(phase)
    engine = rec.engine
    trainer = engine.epoch_fn
    unit = STEP_UNITS.get(rec.model.batch_kind, "positives")
    negs = f" (x {trainer.neg_shape[0]} negatives)" if getattr(trainer, "neg_shape", ()) else ""
    rates = [trainer.num_batches * trainer.batch_size / s for s in engine.epoch_seconds]
    log(phase, f"{len(rates)} epochs of {trainer.num_batches} steps x {trainer.batch_size} {unit}{negs}, best "
        f"epoch {result['best_epoch']}, train() {result['run_time']:.2f} s; {unit}/s per epoch: "
        + ", ".join(f"{r:.0f}" for r in rates))
    if len(rates) > 1:
        log(phase, f"{unit}/s after the first epoch: median {np.median(rates[1:]):.1f}, "
            f"min {min(rates[1:]):.1f}, max {max(rates[1:]):.1f}")
    log(phase, f"best valid ndcg@10 {result['valid_metric']:.6f}; test() "
        + ", ".join(f"{k} {res[k]:.6f}" for k in sorted(res) if k.endswith("@10"))
        + f" in {test_s * 1e3:.2f} ms, peak device memory {peak / 2**30:.3f} GiB ({before / 2**30:.3f} GiB held "
        "before it)")
    return rec, result, res, counts


def train_graph(name, phase, seed, root_dir, data, **model):
    return train_dense(GRAPH_FAMILY[name][0](graph_config(name, seed, root_dir, **model)), phase, data)


def repeats_bit_for_bit(name, phase, seed, epochs, train, params_from_jax, main=None):
    """Two more trainings (``train(phase, max_epoch)``) of ``epochs`` epochs
    of one seed give the same best and last parameters and every epoch's
    metrics, bit for bit. ``main``, the (recommender, result) of the seed's
    longer training, stands in for the first of them where its best epoch
    is the last of those ``epochs``: its best checkpoint then holds their
    last parameters."""
    def saved(result, *where):
        return params_from_jax(load_raw_checkpoint(os.path.join(result["model_save_dir"], *where))["params"])

    again, again_result, _, _ = train(f"{phase}-repeat", epochs)
    if main is not None and main[1]["best_epoch"] == epochs - 1:
        (first, first_result), twice = main, "one more training"
        first_last, history = saved(first_result), first.engine.bookkeeper.history[:epochs]
    else:
        first, first_result, _, _ = train(f"{phase}-repeat", epochs)
        first_last, history, twice = saved(first_result, "last"), first.engine.bookkeeper.history, "two more trainings"
    last = saved(again_result, "last")
    best = [r.model.state_dict() for r in (first, again)]
    same = (all(torch.equal(best[0][key], best[1][key]) for key in best[0])
            and all(torch.equal(first_last[key], last[key]) for key in last)
            and history == again.engine.bookkeeper.history)
    if not same:
        fail(f"two {name} trainings of {epochs} epochs of one seed gave different parameters")
    log(phase, f"{twice} of seed {seed} for {epochs} epochs gave the same best and last parameters and every "
        f"epoch's metrics bit for bit{' as the training above' if twice.startswith('one') else ''}")


def graph_training(seed, root_dir, data):
    """Phases 21-22: each model to early stop inside the JAX band, LightGCN's
    first epochs twice bit for bit, and a profiled epoch of each. Returns the
    kernels' counts by path."""
    counts = {}
    for name in GRAPH_FAMILY:
        phase = f"{name.lower()}-train"
        rec, result, res, counts[phase] = train_graph(name, phase, seed, root_dir, data)
        band = GRAPH_BANDS[name]
        log(phase, in_band("best valid ndcg@10", result["valid_metric"], band["valid"]) + "; "
            + in_band("test ndcg@10", res["ndcg@10"], band["test"]))
        check_graph_serving(phase, rec)
        if name == "LightGCN":
            repeats_bit_for_bit(name, phase, seed, REPEAT_EPOCHS, lambda p, epochs: train_graph(
                name, p, seed, root_dir, data, max_epoch=epochs), lightgcn_params_from_jax)
    return counts


def graph_phases(seed, root_dir):
    """Phases 20-22 (profiled by ``--profile graph-models``). Returns the
    kernels' counts by path (all 0)."""
    data = mf_split()
    counts = serve_graph_checkpoints(root_dir, data)
    counts.update(graph_training(seed, root_dir, data))
    return counts


# -- the multineg models and the memory network (phases 23-25) -------------------


def capped_config(name, seed, root_dir, **model):
    """The shipped config capped at its band's epochs (CAPPED_FAMILY)."""
    return shipped_config(CAPPED_FAMILY[name][1], seed, root_dir, **{"max_epoch": CAPPED_FAMILY[name][2], **model})


def serve_ultragcn_checkpoint(root_dir, data):
    """Phase 23: the checkpoint's load, test(), predict() and recommend()
    against the JAX package's metrics and the port on the CPU. Returns the
    kernels' counts on the path."""
    phase = "ultragcn-serve"
    path = os.path.join(REPO, "parity_runs/checkpoints", ULTRAGCN_CHECKPOINT)
    cfg = load_config(path).replace(system={"root_dir": root_dir})
    zero_kernel_counts()
    rec = UltraGCN(cfg).load(path, data)
    res = rec.test()
    for key, want in EXPECTED_ULTRAGCN_METRICS.items():
        if abs(res[key] - want) > METRIC_TOL:
            fail(f"UltraGCN checkpoint test() {key} = {res[key]:.6f}, expected {want} +- {METRIC_TOL}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.test()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    pairs = {c: data.test[0][c][:300] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    scores = rec.predict(pairs)
    k = 10
    rec.recommend(k=k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = rec.recommend(k=k)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    check_recommendations(recs, data, k, data.n_users)
    counts = check_no_kernel(phase)
    plain = UltraGCN(cfg, device="cpu").load(path, data)
    err = float(np.abs(scores - plain.predict(pairs)).max())
    if err > PREDICT_TOL:
        fail(f"{phase}: predict() differs from the CPU's by {err}")
    if same_top_k(recs, plain.recommend(k=k), k):
        fail(f"{phase}: the top-{k} lists differ from the CPU's")
    n_eval = len(data.eval_candidates(data.test[0]).users)
    log(phase, "test() " + ", ".join(f"{key} {res[key]:.6f}" for key in EXPECTED_ULTRAGCN_METRICS)
        + f" (expected to {METRIC_TOL}); predict(300 pairs) max |d| vs the CPU {err:.3g}; recommend(k={k}) "
        f"{data.n_users} users, no train item, the CPU's lists for every user; no kernel launched")
    log(phase, f"test() {n_eval / test_s:.1f} users/s ({test_s * 1e3:.2f} ms); recommend() "
        f"{data.n_users / rec_s:.1f} users/s ({rec_s * 1e3:.2f} ms)")
    return counts


def train_capped(name, phase, seed, root_dir, data, pretrained=None, **model):
    rec = CAPPED_FAMILY[name][0](capped_config(name, seed, root_dir, **model), **(pretrained or {}))
    return train_dense(rec, phase, data)


def check_band(name, phase, result, res):
    band = CAPPED_BANDS[name]
    log(phase, f"(cap {CAPPED_FAMILY[name][2]} epochs) "
        + in_band("best valid ndcg@10", result["valid_metric"], band["valid"]) + "; "
        + in_band("test ndcg@10", res["ndcg@10"], band["test"]))


def multineg_training(seed, root_dir, data):
    """Phase 24: UltraGCN and MixGCF at their capped shipped configs inside
    the JAX bands, UltraGCN's first epochs twice bit for bit. Returns the
    kernels' counts by path."""
    counts = {}
    for name in ("UltraGCN", "MixGCF"):
        phase = f"{name.lower()}-train"
        rec, result, res, counts[phase] = train_capped(name, phase, seed, root_dir, data)
        check_band(name, phase, result, res)
        check_graph_serving(phase, rec)
        if name == "UltraGCN":
            repeats_bit_for_bit(name, phase, seed, REPEAT_EPOCHS, lambda p, epochs: train_capped(
                name, p, seed, root_dir, data, max_epoch=epochs), flatten_params)
    return counts


class DrawReplay:
    """Inside the block, SGL's subgraph draws, SimGCL's noise draws, the
    dropout masks, the flash attention's dropout seeds, VAECF's and VBCAR's
    (TVBR's) latent noise and the ReLU decisions (``ops.activations.relu``:
    the FFN's and the MLP tower's) of a recording run are kept in order and
    handed, in that order, to a replaying run (``replaying`` True): the same
    draws and the same branches on the card and on the CPU (a pre-activation
    within rounding of 0 may fall on either side: at TiSASRec's step 2 at
    the shipped width one did, and moved a gradient by 2.3e-5, PERF.md
    section 6). Each function takes its device, or a tensor on it, last."""

    def __init__(self):
        self.queue = collections.deque()
        self.replaying = False
        self._saved = []

    def _wrap(self, real):
        def draw(*args):
            if self.replaying:
                where = args[-1]
                return self.queue.popleft().to(where.device if isinstance(where, torch.Tensor) else where)
            out = real(*args)
            self.queue.append(out)
            return out

        return draw

    def __enter__(self):
        for module, name in ((sgl_model, "sgl_draws"), (simgcl_model, "perturbation_noise"),
                             (port_attention, "dropout_mask"), (port_attention, "dropout_seed"),
                             (vaecf_model, "latent_noise"), (vbcar_model, "latent_noise")):
            self._saved.append((module, name, getattr(module, name)))
            setattr(module, name, self._wrap(getattr(module, name)))
        keep = self._wrap(lambda z: z > 0)
        self._saved.append((port_activations, "relu", port_activations.relu))
        port_activations.relu = lambda z: torch.where(keep(z), z, 0.0)  # torch.relu's values and gradient
        return self

    def __exit__(self, *exc):
        for module, name, real in self._saved:
            setattr(module, name, real)


def steps_match_cpu(phase, start, engine, data, steps, tol, eps_set=0.0, mesh_devices=None):
    """``steps`` optimizer steps from ``engine``'s weights (on the device of
    ``start``, the recommender that built it) and through the port on the
    CPU, on the batches ``engine`` forms and the same draws (``DrawReplay``):
    each step's loss (relative to max(1, |loss|)), every parameter and every
    optimizer moment must agree to ``tol``. With ``eps_set`` > 0 (Adam), a
    parameter element whose gradient lay below ``eps_set`` on both sides at
    some step is eps-set: Adam moves it by lr * g / (|g| + 1e-8), so the
    rounding of a gradient that is a near-cancellation moves it by up to lr.
    Such elements alone may pass ``tol`` (at most EPS_SET_SHARE of the
    elements, each within lr a step). Returns the largest differences (the
    eps-set elements apart), the dense A's the card built a step, and a
    report of the eps-set elements past ``tol``. A config with a mesh runs on
    ``mesh_devices`` of the CPU there."""
    cpu = type(start)(start.config, device="cpu")
    cpu.data = data
    cpu_engine = TrainEngine(cpu.config, cpu.device, mesh_devices).build(cpu._build_model(data.n_users, data.n_items),
                                                                         data)
    cpu_engine.model.load_state_dict(engine.model.state_dict())
    batches = [x[:steps] for x in engine.epoch_fn.form(engine.generator)]
    params = dict(engine.model.named_parameters())
    tiny = {name: torch.zeros(p.shape, dtype=torch.bool) for name, p in cpu_engine.model.named_parameters()}
    prop = getattr(engine.model, "prop", None)
    built = []
    if prop is not None:  # count the card's rebuilds of A from per-step edge values
        real_operator = prop.operator
        prop.operator = lambda vals=None: built.append(vals is not None) or real_operator(vals)
    diff = {"loss": 0.0, "parameters": 0.0}
    try:
        with DrawReplay() as replay:
            for s in range(steps):
                replay.replaying = False
                loss = float(engine.epoch_fn.run_batches(*(x[s:s + 1] for x in batches), generator=engine.generator))
                replay.replaying = True
                cpu_loss = float(cpu_engine.epoch_fn.run_batches(*(x[s:s + 1] for x in batches),
                                                                 generator=cpu_engine.generator))
                if replay.queue:
                    fail(f"{phase}: the CPU's step {s} took {len(replay.queue)} draws fewer than the card's")
                diff["loss"] = max(diff["loss"], abs(loss - cpu_loss) / max(1.0, abs(cpu_loss)))
                for name, p in cpu_engine.model.named_parameters():
                    if p.grad is not None and params[name].grad is not None:
                        tiny[name] |= torch.maximum(p.grad.abs(), params[name].grad.detach().abs().cpu()) < eps_set
    finally:
        if prop is not None:
            del prop.operator
    past, past_max, n_elements = 0, 0.0, 0
    for name, p in cpu_engine.model.named_parameters():
        d = (params[name].detach().cpu() - p.detach()).abs()
        excused = (d > tol) & tiny[name]
        past, n_elements = past + int(excused.sum()), n_elements + d.numel()
        if excused.any():
            past_max = max(past_max, float(d[excused].max()))
        diff["parameters"] = max(diff["parameters"], float(d.masked_fill(excused, 0.0).max()))
        for key, moment in cpu_engine.optimizer.state.get(p, {}).items():
            if key != "step":
                d = float((engine.optimizer.state[params[name]][key].cpu() - moment).abs().max())
                diff[key] = max(diff.get(key, 0.0), d)
    lr = float(start.config.model.get("lr", 1e-3))
    if max(diff.values()) > tol or past > EPS_SET_SHARE * n_elements or past_max > lr * steps:
        fail(f"{phase}: {steps} steps differ from the CPU's by {diff} (limit {tol}); {past} eps-set elements "
             f"past it by up to {past_max}")
    report = (f"; {past} eps-set element(s) of {n_elements} (gradient below {eps_set:g} on both sides at a step) "
              f"past the limit, by up to {past_max:.3g} (lr x steps {lr * steps:g})" if past else "")
    return diff, sum(built) / steps, report


def describe_steps(diff, tol):
    return "max |d| " + ", ".join(f"{key} {value:.3g}" for key, value in diff.items()) + f" (limit {tol})"


def cmn_steps_match_cpu(phase, start, engine, data, steps=CMN_CPU_STEPS):
    """``steps`` rmsprop steps of CMN from ``engine``'s initial weights
    against the same steps through the port on the CPU (``steps_match_cpu``,
    rmsprop's nu the moment, limit CMN_CPU_TOL)."""
    diff, _, _ = steps_match_cpu(phase, start, engine, data, steps, CMN_CPU_TOL)
    width = engine.model.item_neighbors.shape[1]
    return (f"{steps} rmsprop steps at emb {engine.model.emb_dim}, {engine.model.hops} hops over neighbourhoods "
            f"{width} users wide, from the warm-started weights, equal the CPU's on the same batches: "
            + describe_steps(diff, CMN_CPU_TOL))


def memory_training(seed, root_dir, data):
    """Phase 25: PairwiseGMF, then CMN (rmsprop) warm-started from its best
    memories, each at its capped shipped config inside the JAX band; CMN
    starts from the memories bit for bit, its first steps equal the CPU's,
    its first epochs twice bit for bit, and its test()'s peak device memory. Returns the kernels' counts by
    path."""
    counts = {}
    phase = "pairwise-gmf-train"
    gmf, result, res, counts[phase] = train_capped("PairwiseGMF", phase, seed, root_dir, data)
    check_band("PairwiseGMF", phase, result, res)
    check_graph_serving(phase, gmf)
    phase = "cmn-train"
    pretrained = {"user_embeddings": gmf.model.user_memory.detach(), "item_embeddings": gmf.model.item_memory.detach()}
    start = CMN(capped_config("CMN", seed, root_dir), **pretrained)
    start.data = data
    model = start._build_model(data.n_users, data.n_items)
    engine = TrainEngine(start.config, start.device).build(model, data)  # the weights train() starts from
    if not (torch.equal(model.user_memory, gmf.model.user_memory)
            and torch.equal(model.item_memory, gmf.model.item_memory)):
        fail(f"{phase}: CMN's initial memories are not PairwiseGMF's")
    log(phase, "CMN's initial user and item memories equal the trained PairwiseGMF's bit for bit")
    log(phase, cmn_steps_match_cpu(phase, start, engine, data))
    rec, result, res, counts[phase] = train_capped("CMN", phase, seed, root_dir, data, pretrained)
    check_band("CMN", phase, result, res)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rec.test()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    n_eval = len(data.eval_candidates(data.test[0]).users)
    width, mean_len = rec.model.item_neighbors.shape[1], float(rec.model.item_nb_len.float().mean())
    log(phase, f"test() {n_eval / test_s:.1f} users/s ({test_s * 1e3:.2f} ms), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({before / 2**30:.3f} GiB held before it); "
        f"neighbourhoods {width} users wide, {mean_len:.1f} an item on average: "
        f"{1 - mean_len / width:.1%} of the gathered slots are padding")
    check_graph_serving(phase, rec)
    counts[phase] = check_no_kernel(phase)  # since train_dense zeroed them: train(), test() and the serving
    repeats_bit_for_bit("CMN", phase, seed, CMN_REPEAT_EPOCHS, lambda p, epochs: train_capped(
        "CMN", p, seed, root_dir, data, pretrained, max_epoch=epochs), flatten_params, main=(rec, result))
    return counts


def capped_phases(seed, root_dir):
    """Phases 23-25 (profiled by ``--profile capped-models``). Returns the
    kernels' counts by path (all 0)."""
    data = mf_split()
    counts = {"ultragcn-serve": serve_ultragcn_checkpoint(root_dir, data)}
    counts.update(multineg_training(seed, root_dir, data))
    counts.update(memory_training(seed, root_dir, data))
    return counts


# -- the self-supervised graph models (phases 26-27) ----------------------------


def ssl_config(name, seed, root_dir, **model):
    """The shipped config capped at its band's epochs (SSL_FAMILY)."""
    return shipped_config(SSL_FAMILY[name][1], seed, root_dir, **{"max_epoch": SSL_FAMILY[name][2], **model})


def built_engine(rec, data):
    """(rec, engine) with the engine built as rec.train(data) builds it (on
    rec's mesh devices where its config has a mesh): the weights its training
    starts from."""
    rec.data = data
    return rec, TrainEngine(rec.config, rec.device, rec.mesh_devices).build(
        rec._build_model(data.n_users, data.n_items), data)


def ssl_engine(name, seed, root_dir, data, device=None, **model):
    """``built_engine`` at the capped shipped config."""
    return built_engine(SSL_FAMILY[name][0](ssl_config(name, seed, root_dir, **model), device=device), data)


def buir_target_after_one_step(phase, seed, root_dir, data, device=None, **model):
    """BUIR's target after its first step equals m * initial + (1 - m) *
    online, the online tables after that step (BUIR_EMA_TOL)."""
    _, engine = ssl_engine("BUIR", seed, root_dir, data, device, **model)
    model = engine.model
    initial = {key: model.target[key].detach().clone() for key in ("user_emb", "item_emb")}
    if not all(torch.equal(initial[key], model.online[key]) for key in initial):
        fail(f"{phase}: BUIR's initial target is not a copy of its online encoder")
    engine.epoch_fn.run_batches(*(x[:1] for x in engine.epoch_fn.form(engine.generator)), generator=engine.generator)
    m = model.momentum
    with torch.no_grad():
        err = max(float((model.target[key] - (initial[key] * m + model.online[key] * (1 - m))).abs().max())
                  for key in initial)
        moved = max(float((model.online[key] - initial[key]).abs().max()) for key in initial)
    if err > BUIR_EMA_TOL or moved == 0:
        fail(f"{phase}: after one step the target is {err} from m * initial + (1 - m) * online (online moved {moved})")
    return (f"after one step the target is within {err:.3g} of {m} * initial + {1 - m:.3g} * online (online moved "
            f"{moved:.3g})")


def ssl_training(name, seed, root_dir, data):
    """One model of phases 26-27: its first steps against the CPU's, its
    capped training inside the JAX band (held where the band's lower edge
    reaches UNTRAINED_NDCG, else reported: there the steps hold the model),
    its serving, and (SGL, BUIR) its first epochs twice bit for bit. Returns
    the kernels' counts on its path."""
    phase = f"{name.lower()}-train"
    start, engine = ssl_engine(name, seed, root_dir, data)
    diff, rebuilds, eps_set = steps_match_cpu(phase, start, engine, data, SSL_CPU_STEPS, SSL_CPU_TOL, SSL_EPS_SET)
    band = SSL_BANDS[name]
    weak = [key for key in band if band[key][0] - 3 * band[key][1] < UNTRAINED_NDCG]
    log(phase, f"{SSL_CPU_STEPS} Adam steps at emb {engine.model.emb_dim} from the initial weights equal the CPU's on "
        f"the same batches and draws: {describe_steps(diff, SSL_CPU_TOL)}{eps_set}; dense A's built a step "
        f"{rebuilds:g}" + (f"; the band's lower edge ({', '.join(weak)}) lies below {UNTRAINED_NDCG}, so these "
                            "steps are the check that can fail an untrained model" if weak else ""))
    if name == "BUIR":
        log(phase, buir_target_after_one_step(phase, seed, root_dir, data))
    rec, result, res, counts = train_dense(SSL_FAMILY[name][0](ssl_config(name, seed, root_dir)), phase, data)
    held = band_position if weak else in_band  # a band that cannot fail an untrained model is reported only
    log(phase, f"(cap {SSL_FAMILY[name][2]} epochs) "
        + held("best valid ndcg@10", result["valid_metric"], band["valid"]) + "; "
        + held("test ndcg@10", res["ndcg@10"], band["test"])
        + ("; reported, not held: the steps above hold this model" if weak else ""))
    if name == "BUIR":  # as the JAX model, BUIR has no pair score
        recs = rec.recommend(k=10)
        torch.cuda.synchronize()
        check_recommendations(recs, data, 10, data.n_users)
        try:
            rec.predict({c: data.test[0][c][:10] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)})
            fail(f"{phase}: predict() returned scores; the JAX BUIR raises NotImplementedError")
        except NotImplementedError:
            log(phase, f"recommend(k=10) {data.n_users} users well-formed, no train item; predict() raises "
                "NotImplementedError, as the JAX package's")
    else:
        check_graph_serving(phase, rec)
    counts = check_no_kernel(phase)  # since train_dense zeroed them: train(), test() and the serving
    if name in ("SGL", "BUIR"):
        repeats_bit_for_bit(name, phase, seed, SSL_REPEAT_EPOCHS, lambda p, epochs: train_dense(
            SSL_FAMILY[name][0](ssl_config(name, seed, root_dir, max_epoch=epochs)), p, data), flatten_params)
    if name == "LCFN":
        t0 = time.perf_counter()
        again = mf_split().get_graph_embeddings(float(rec.config.model.get("cut_off", 0.2)))
        secs = time.perf_counter() - t0
        if not all(torch.equal(torch.as_tensor(a, device=rec.device), b) for a, b in zip(again, (rec.model.P,
                                                                                                  rec.model.Q))):
            fail(f"{phase}: P and Q of a second eigendecomposition differ from the trained model's")
        log(phase, f"a second eigendecomposition on a fresh data object ({secs:.2f} s) gives P {tuple(again[0].shape)} "
            f"and Q {tuple(again[1].shape)} bit for bit as the main run's")
    return counts


def ssl_phases(seed, root_dir):
    """Phases 26-27 (profiled by ``--profile ssl-models``). Returns the
    kernels' counts by path (all 0)."""
    data = mf_split()
    cut_off = float(load_config(os.path.join(REPO, SSL_FAMILY["LCFN"][1])).model.get("cut_off", 0.2))
    t0 = time.perf_counter()
    p, q = data.get_graph_embeddings(cut_off)
    log("lcfn-train", f"LCFN's eigendecomposition on the host: P {p.shape}, Q {q.shape} in "
        f"{time.perf_counter() - t0:.2f} s (kept on the data object for every later build)")
    counts = {}
    for name in SSL_FAMILY:
        t0 = time.perf_counter()
        counts[f"{name.lower()}-train"] = ssl_training(name, seed, root_dir, data)
        log(f"{name.lower()}-train", f"phase took {time.perf_counter() - t0:.2f} s")
    return counts


# -- the sequential and VAE models (phases 28-30) -------------------------------


def seq_config(name, seed, root_dir, **model):
    """The shipped config capped at its band's epochs (SEQ_FAMILY)."""
    return shipped_config(SEQ_FAMILY[name][1], seed, root_dir, **{"max_epoch": SEQ_FAMILY[name][2], **model})


def seq_split():
    """The structured split as a SequentialData (which VAECF also takes)."""
    return SequentialData(load_split_data(SPLIT, n_test=1))


def seq_engine(name, seed, root_dir, data, device=None, **model):
    """``built_engine`` at the capped shipped config."""
    return built_engine(SEQ_FAMILY[name][0](seq_config(name, seed, root_dir, **model), device=device), data)


def timed_test(rec):
    """(test() row, seconds of one more test())."""
    res = rec.test()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.test()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def serves_as_the_cpu(phase, rec, data, ckpt_dir, res):
    """The checkpoint at ``ckpt_dir`` served by the port on the CPU gives
    ``rec``'s test() row ``res`` to SERVE_CPU_TOL, its predict() to
    PREDICT_TOL relative to max(1, |score|) (NARM's logits reach ~16, where
    one float32 step is 1.9e-6) and its top-10 lists; ``rec``'s lists are
    well-formed."""
    cpu = type(rec)(rec.config, device="cpu").load(ckpt_dir, data)
    want = cpu.test()
    gap = max(abs(res[key] - want[key]) for key in want)
    pairs = {c: data.test[0][c][:300] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)}
    scores = rec.predict(pairs)
    if scores.shape != (300,) or not np.isfinite(scores).all():
        fail(f"{phase}: predict() gave {scores.shape} with non-finite values")
    want_scores = cpu.predict(pairs)
    err = float((np.abs(scores - want_scores) / np.maximum(1.0, np.abs(want_scores))).max())
    k = 10
    recs = rec.recommend(k=k)
    torch.cuda.synchronize()
    check_recommendations(recs, data, k, data.n_users)
    if gap > SERVE_CPU_TOL or err > PREDICT_TOL or same_top_k(recs, cpu.recommend(k=k), k):
        fail(f"{phase}: the card's serving differs from the CPU's: test() by {gap} (limit {SERVE_CPU_TOL}), "
             f"predict() by {err} (limit {PREDICT_TOL}), or the top-{k} lists")
    return (f"test() within {gap:.3g} of the CPU's, predict(300 pairs) within {err:.3g} (relative to max(1, "
            f"|score|), scores up to {np.abs(want_scores).max():.3g}); recommend(k={k}) "
            f"{data.n_users} users, no train item, the CPU's lists for every user")


def serve_vaecf_checkpoint(root_dir, data):
    """Phase 30's serving: the JAX-trained seed-0 VAECF checkpoint's load,
    test(), predict() and recommend() against the JAX package's metrics
    and the port on the CPU. Returns the kernels' counts on the path."""
    phase = "vaecf-serve"
    path = os.path.join(REPO, "parity_runs/checkpoints", VAECF_CHECKPOINT)
    zero_kernel_counts()
    rec = VAECF(load_config(path).replace(system={"root_dir": root_dir})).load(path, data)
    res, test_s = timed_test(rec)
    for key, want in EXPECTED_VAECF_METRICS.items():
        if abs(res[key] - want) > METRIC_TOL:
            fail(f"VAECF checkpoint test() {key} = {res[key]:.6f}, expected {want} +- {METRIC_TOL}")
    report = serves_as_the_cpu(phase, rec, data, path, res)
    counts = check_no_kernel(phase)
    n_eval = len(data.eval_candidates(data.test[0]).users)
    log(phase, "test() " + ", ".join(f"{key} {res[key]:.6f}" for key in EXPECTED_VAECF_METRICS)
        + f" (expected to {METRIC_TOL}); {report}; no kernel launched; test() {n_eval / test_s:.1f} users/s "
        f"({test_s * 1e3:.2f} ms)")
    return counts


def seq_training(name, seed, root_dir, data):
    """One model of phases 28-30: (TiSASRec) its first steps against the
    CPU's, its capped training against the JAX band (held where the band's
    lower edge lies above UNTRAINED_NDCG, else reported: there the steps
    hold the model), its serving against the CPU's, and its first epochs
    twice bit for bit. Returns the kernels' counts on its path."""
    phase = f"{name.lower()}-train"
    cls, _, cap = SEQ_FAMILY[name]
    band = SEQ_BANDS[name]
    weak = [key for key in band if band[key][0] - 3 * band[key][1] < UNTRAINED_NDCG]
    if weak:
        start, engine = seq_engine(name, seed, root_dir, data)
        diff, _, eps_set = steps_match_cpu(phase, start, engine, data, SEQ_CPU_STEPS, SSL_CPU_TOL, SSL_EPS_SET)
        log(phase, f"{SEQ_CPU_STEPS} Adam steps at emb {engine.model.emb_dim} from the initial weights equal the "
            f"CPU's on the same batches, dropout masks and ReLU decisions: "
            f"{describe_steps(diff, SSL_CPU_TOL)}{eps_set}; the "
            f"band's lower edge ({', '.join(weak)}) lies below {UNTRAINED_NDCG}, so these steps are the check that "
            "can fail an untrained model")
    rec, result, res, _ = train_dense(cls(seq_config(name, seed, root_dir)), phase, data)
    held = band_position if weak else in_band
    log(phase, (f"(cap {cap} epochs) " if cap < 200 else "(to early stop) ")
        + held("best valid ndcg@10", result["valid_metric"], band["valid"]) + "; "
        + held("test ndcg@10", res["ndcg@10"], band["test"])
        + ("; reported, not held: the steps above hold this model" if weak else ""))
    log(phase, serves_as_the_cpu(phase, rec, data, result["model_save_dir"], res))
    counts = check_no_kernel(phase)  # since train_dense zeroed them: train(), test() and the serving
    repeats_bit_for_bit(name, phase, seed, SEQ_REPEAT_EPOCHS[name], lambda p, epochs: train_dense(
        cls(seq_config(name, seed, root_dir, max_epoch=epochs)), p, data), flatten_params)
    return counts


def seq_phases(seed, root_dir):
    """Phases 28-30 (profiled by ``--profile seq-models``). Returns the
    kernels' counts by path (all 0)."""
    data = seq_split()
    counts = {}
    for name in SEQ_FAMILY:
        t0 = time.perf_counter()
        if name == "VAECF":
            counts["vaecf-serve"] = serve_vaecf_checkpoint(root_dir, data)
        counts[f"{name.lower()}-train"] = seq_training(name, seed, root_dir, data)
        log(f"{name.lower()}-train", f"phase took {time.perf_counter() - t0:.2f} s")
    return counts


# -- the grocery and neighbourhood models (phases 31-33) -------------------------


def grocery_config(name, seed, root_dir, **model):
    """The shipped config capped at its band's epochs (GROCERY_FAMILY)."""
    return shipped_config(GROCERY_FAMILY[name][1], seed, root_dir, **{"max_epoch": GROCERY_FAMILY[name][2], **model})


def grocery_split():
    """The structured split with examples/parity_check.py's synthetic
    baskets (each user's train interactions in timestamp order, five to a
    basket), as a GroceryData."""
    train, valid, test = load_split_data(SPLIT, n_test=1)
    return GroceryData((add_synthetic_baskets(train), valid, test))


def grocery_engine(name, seed, root_dir, data, device=None, **model):
    """``built_engine`` at the capped shipped config."""
    return built_engine(GROCERY_FAMILY[name][0](grocery_config(name, seed, root_dir, **model), device=device), data)


def held_to(phase, got, want, what):
    """Each metric of ``want`` in the test() row ``got`` to SERVING_TOL."""
    gap = max(abs(got[key] - value) for key, value in want.items())
    if gap > SERVING_TOL:
        fail(f"{phase}: {what} test() " + ", ".join(f"{key} {got[key]:.7f}" for key in want)
             + f" differs from the JAX package's {want} by {gap} (limit {SERVING_TOL})")
    return ", ".join(f"{key} {got[key]:.6f}" for key in want) + f" (the JAX package's within {gap:.2g})"


def serve_grocery_and_knn(seed, root_dir, data):
    """Phase 31: the JAX-trained seed-0 Triple2vec checkpoint's load, test(),
    predict() and recommend() against the JAX package's metrics and the
    port on the CPU; UserKNN and ItemKNN at neighbourhood 50 trained (one
    evaluation, no epoch) and tested against the JAX package's metrics,
    recommend() well-formed and predict() raising as the JAX package's.
    Returns the kernels' counts by path."""
    counts = {}
    n_eval = len(data.eval_candidates(data.test[0]).users)
    phase = "triple2vec-serve"
    path = os.path.join(REPO, "parity_runs/checkpoints", TRIPLE2VEC_CHECKPOINT)
    zero_kernel_counts()
    rec = Triple2vec(load_config(path).replace(system={"root_dir": root_dir})).load(path, data)
    res, test_s = timed_test(rec)
    report = held_to(phase, res, EXPECTED_TRIPLE2VEC_METRICS, "the Triple2vec checkpoint's")
    log(phase, f"test() {report}; {serves_as_the_cpu(phase, rec, data, path, res)}; test() "
        f"{n_eval / test_s:.1f} users/s ({test_s * 1e3:.2f} ms)")
    counts[phase] = check_no_kernel(phase)
    knn_data = mf_split()
    for name, (cls, config) in KNN_FAMILY.items():
        phase = f"{name.lower()}-serve"
        zero_kernel_counts()
        rec = cls(shipped_config(config, seed, root_dir))
        result = rec.train(knn_data)
        if rec.engine.epoch_fn is not None or result["best_epoch"] != 0:
            fail(f"{phase}: train() ran epochs ({result}); the batch kind 'none' evaluates once")
        res, test_s = timed_test(rec)
        report = held_to(phase, res, EXPECTED_KNN_METRICS[name], name)
        recs = rec.recommend(k=10)
        torch.cuda.synchronize()
        check_recommendations(recs, knn_data, 10, knn_data.n_users)
        try:
            rec.predict({c: knn_data.test[0][c][:10] for c in (DEFAULT_USER_COL, DEFAULT_ITEM_COL)})
            fail(f"{phase}: predict() returned scores; the JAX {name} raises NotImplementedError")
        except NotImplementedError:
            pass
        log(phase, f"neighbourhood {rec.model.k}: train() one evaluation in {result['run_time'] * 1e3:.2f} ms; "
            f"test() {report}, {n_eval / test_s:.1f} users/s ({test_s * 1e3:.2f} ms); recommend(k=10) "
            f"{knn_data.n_users} users well-formed, no train item; predict() raises NotImplementedError, as the "
            "JAX package's")
        counts[phase] = check_no_kernel(phase)
    return counts


def grocery_training(name, seed, root_dir, data):
    """One model of phases 32-33: (where its band's lower edge lies below
    UNTRAINED_NDCG) its first steps against the CPU's, its capped training
    against the JAX band, its serving against the CPU's, and its first
    epochs twice bit for bit. Returns the kernels' counts on its path."""
    phase = f"{name.lower()}-train"
    cls, _, cap = GROCERY_FAMILY[name]
    band = GROCERY_BANDS[name]
    weak = [key for key in band if band[key][0] - 3 * band[key][1] < UNTRAINED_NDCG]
    if weak:
        start, engine = grocery_engine(name, seed, root_dir, data)
        diff, _, eps_set = steps_match_cpu(phase, start, engine, data, SEQ_CPU_STEPS, SSL_CPU_TOL, SSL_EPS_SET)
        log(phase, f"{SEQ_CPU_STEPS} Adam steps at emb {engine.model.emb_dim} from the initial weights equal the "
            f"CPU's on the same batches and noise: {describe_steps(diff, SSL_CPU_TOL)}{eps_set}; the band's lower "
            f"edge ({', '.join(weak)}) lies below {UNTRAINED_NDCG}, so these steps are the check that can fail an "
            "untrained model")
    rec, result, res, _ = train_dense(cls(grocery_config(name, seed, root_dir)), phase, data)
    trainer = rec.engine.epoch_fn
    held = band_position if weak else in_band
    log(phase, f"(cap {cap} epochs; {trainer.n} triples drawn from the seed, {trainer.n_neg} negatives of each "
        "kind a triple) " + held("best valid ndcg@10", result["valid_metric"], band["valid"]) + "; "
        + held("test ndcg@10", res["ndcg@10"], band["test"])
        + ("; reported, not held: the steps above hold this model" if weak else ""))
    log(phase, serves_as_the_cpu(phase, rec, data, result["model_save_dir"], res))
    counts = check_no_kernel(phase)  # since train_dense zeroed them: train(), test() and the serving
    repeats_bit_for_bit(name, phase, seed, GROCERY_REPEAT_EPOCHS, lambda p, epochs: train_dense(
        cls(grocery_config(name, seed, root_dir, max_epoch=epochs)), p, data), flatten_params)
    return counts


def grocery_phases(seed, root_dir):
    """Phases 31-33 (profiled by ``--profile grocery-models``). Returns the
    kernels' counts by path (all 0)."""
    data = grocery_split()
    t0 = time.perf_counter()
    counts = serve_grocery_and_knn(seed, root_dir, data)
    log("knn-serve", f"phase 31 took {time.perf_counter() - t0:.2f} s")
    for name in GROCERY_FAMILY:
        t0 = time.perf_counter()
        counts[f"{name.lower()}-train"] = grocery_training(name, seed, root_dir, data)
        log(f"{name.lower()}-train", f"phase took {time.perf_counter() - t0:.2f} s")
    return counts


# -- the serving surface, retrieval at scale and resume (phases 34-36) ------------


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(fn, device):
    """(result, seconds) of one call of ``fn`` after a first, untimed one."""
    fn()
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def eval_relevance(data):
    """(users, relevance CSR) of the first test copy: the users with a
    positive (rating >= 1), sorted, and those positives as ones, as
    port_tools/jax_full_catalog_metrics.py builds them."""
    import scipy.sparse as sp

    test = data.test[0]
    pos = test[DEFAULT_RATING_COL] >= 1
    u, i = test[DEFAULT_USER_COL][pos].astype(np.int64), test[DEFAULT_ITEM_COL][pos].astype(np.int64)
    return np.unique(u), sp.csr_matrix((np.ones(len(u), np.float32), (u, i)), shape=(data.n_users, data.n_items))


def same_ids(phase, what, got, want, score_of, limit=NEAR_TIE):
    """Top-k id lists ``got`` and ``want`` (rows of a (users, k) array) are
    equal, except at ranks where the two items' scores (``score_of(rows,
    ids)``, one score matrix for both) lie within ``limit``: float32
    rounding may order a tie either way. Returns the rows that differ."""
    rows = np.nonzero((got != want).any(axis=1))[0]
    if len(rows):
        gap = np.abs(score_of(rows, got[rows]) - score_of(rows, want[rows]))
        if gap.max() > limit:
            r = int(rows[np.argmax(gap.max(axis=1))])
            fail(f"{phase}: {what}: user {r}'s ids {got[r]} differ from {want[r]} beyond a tie "
                 f"(score gap {gap.max():.3g} > {limit})")
    return len(rows)


def serve_routes(phase, rec, cpu, device, k=10):
    """recommend(k) through each route this model takes, on ``device``
    against the same checkpoint served by the port on the CPU: the default
    (train items excluded), and for a factorized model the fast route in
    both modes with float32 and bfloat16 scores. Float32: the CPU's ids,
    scores to PREDICT_TOL relative to max(1, |score|); bfloat16: the
    overlap with the CPU's ids, reported."""
    cases = [{"exclude_train": True}]
    if rec.model.user_item_embeddings() is not None:
        cases += [{"exclude_train": False, "mode": mode, "score_dtype": dtype}
                  for mode in ("exact", "approx") for dtype in ("float32", "bfloat16")]
    n = rec.data.n_users
    parts = []
    for kw in cases:
        route = recommend_route(rec.model.user_item_embeddings() is not None, k,
                                exclusion_lists(rec.data.user_item_csr()) if kw["exclude_train"] else None)
        got, secs = timed(lambda: rec.recommend(k=k, **kw), device)
        if kw["exclude_train"]:
            check_recommendations(got, rec.data, k, n)
        elif not np.isfinite(got[DEFAULT_PREDICTION_COL]).all():
            fail(f"{phase}: recommend({kw}) returned non-finite scores")
        want = cpu.recommend(k=k, **kw)
        a, b = got[DEFAULT_ITEM_COL].reshape(n, k), want[DEFAULT_ITEM_COL].reshape(n, k)
        label = f"{route} {kw.get('mode', 'exact')} {kw.get('score_dtype') or 'float32'}"
        if kw.get("score_dtype") == "bfloat16":
            overlap = np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)])
            parts.append(f"{label} {n / secs:.1f} users/s, ids overlap the CPU's {overlap:.4f}")
            continue
        err = float((np.abs(got[DEFAULT_PREDICTION_COL] - want[DEFAULT_PREDICTION_COL])
                     / np.maximum(1.0, np.abs(want[DEFAULT_PREDICTION_COL]))).max())
        if not np.array_equal(a, b) or err > PREDICT_TOL:
            fail(f"{phase}: recommend({kw}) on the {route} route differs from the CPU's: "
                 f"{int((a != b).any(axis=1).sum())} rows of ids, scores by {err} (limit {PREDICT_TOL})")
        parts.append(f"{label} {n / secs:.1f} users/s, the CPU's ids, scores within {err:.3g}")
    log(phase, f"recommend(k={k}) over {n} users: " + "; ".join(parts))
    return 2 * len(cases)  # recommend() calls on the device


def evaluators_against_jax(phase, name, rec, device):
    """FullCatalogEvaluator (and, for a factorized model, the exact and
    approx TopKRetrievalEvaluator) of the served model on ``device``: the
    JAX package's metrics to SERVING_TOL, and the two evaluators' metrics
    within SERVING_TOL of each other. Returns the evaluate() calls."""
    users, rel = eval_relevance(rec.data)
    train = rec.data.user_item_csr()
    model = rec.test_model()
    want = EXPECTED_FULL_CATALOG_METRICS[name]
    full, secs = timed(FullCatalogEvaluator(model, users, rel, train).evaluate, device)
    text = [f"FullCatalogEvaluator {held_to(phase, full, want['full_catalog'], 'FullCatalogEvaluator')}, "
            f"{len(users) / secs:.1f} users/s"]
    calls = 2
    if "topk_retrieval" in want:
        topk = TopKRetrievalEvaluator(model, users, rel, train)
        got, secs = timed(topk.evaluate, device)
        text.append(f"TopKRetrievalEvaluator ({'fast' if topk.use_fast else 'streaming'} route) "
                    f"{held_to(phase, got, want['topk_retrieval'], 'TopKRetrievalEvaluator')}, "
                    f"{len(users) / secs:.1f} users/s")
        gap = max(abs(got[key] - full[key]) for key in full)
        if gap > SERVING_TOL:
            fail(f"{phase}: the two evaluators' metrics differ by {gap} (limit {SERVING_TOL})")
        approx = TopKRetrievalEvaluator(model, users, rel, train, mode="approx").evaluate()
        text.append(f"the two agree within {gap:.3g}; mode approx ndcg@10 {approx['ndcg@10']:.6f}")
    log(phase, "; ".join(text))
    return calls


def exported_tables(phase, rec, cpu, root_dir):
    """export_embeddings() written, read back bit-equal to the served
    tables and within PREDICT_TOL (relative to max(1, |x|)) of the CPU's."""
    path = rec.export_embeddings(os.path.join(root_dir, f"{phase.replace('/', '-')}.npz"))
    want = np.load(cpu.export_embeddings(os.path.join(root_dir, f"{phase.replace('/', '-')}-cpu.npz")))
    with np.load(path) as z:
        u, i = (x.detach().cpu().numpy() for x in rec.model.user_item_embeddings_trimmed())
        if not (np.array_equal(z["user_emb"], u) and np.array_equal(z["item_emb"], i)):
            fail(f"{phase}: export_embeddings() did not round-trip the served tables")
        err = max(float((np.abs(z[key] - want[key]) / np.maximum(1.0, np.abs(want[key]))).max())
                  for key in ("user_emb", "item_emb"))
    if err > PREDICT_TOL:
        fail(f"{phase}: exported tables differ from the CPU's by {err} (limit {PREDICT_TOL})")
    return f"export_embeddings() {u.shape} + {i.shape} round-trips, the CPU's within {err:.3g}"


def serve_best_and_final(phase, data, root_dir, device):
    """use_best on a recommender whose engine holds the JAX MF run's last/
    (epoch 33) and whose best checkpoint is epoch 13's: recommend() with
    use_best True, False, True serves best, final, best (the cold loads'
    lists), and test() after it gives the best checkpoint's row."""
    cfg = load_config(MF_CHECKPOINT).replace(system={"root_dir": root_dir})
    rec = MatrixFactorization(cfg, device=device)
    rec.data = data
    rec.model = rec._build_model(data.n_users, data.n_items)
    rec.engine = TrainEngine(cfg, rec.device).build(rec.model, data)
    rec.engine.checkpoint_dir = MF_CHECKPOINT  # the run whose best checkpoint serving reads
    rec.load(os.path.join(MF_CHECKPOINT, "last"))  # a recommender with an engine restores its whole state
    best = MatrixFactorization(cfg, device=device).load(MF_CHECKPOINT, data)
    final = MatrixFactorization(cfg, device=device).load(os.path.join(MF_CHECKPOINT, "last"), data)
    want = {True: best.recommend(k=10)[DEFAULT_ITEM_COL], False: final.recommend(k=10)[DEFAULT_ITEM_COL]}
    for use_best in (True, False, True):
        if not np.array_equal(rec.recommend(k=10, use_best=use_best)[DEFAULT_ITEM_COL], want[use_best]):
            fail(f"{phase}: recommend(use_best={use_best}) is not the {'best' if use_best else 'final'} "
                 "checkpoint's list")
    if rec.test() != best.test():
        fail(f"{phase}: test() after serving the final parameters is not the best checkpoint's")
    differ = int((want[True] != want[False]).reshape(-1, 10).any(axis=1).sum())
    log(phase, f"use_best True, False, True served the best (epoch 13), the final (epoch 33) and the best "
        f"checkpoint's lists ({differ} of {data.n_users} users' lists differ between the two); test() after them "
        "is the best checkpoint's row")


def per_user_against_cpu(phase, data, root_dir, device):
    """test() with save_mode "per_user" writes the same rows on ``device``
    as on the CPU, predictions within PREDICT_TOL."""
    import csv
    import glob

    tables = []
    for label, where in (("served", device), ("cpu", "cpu")):
        root = os.path.join(root_dir, f"per-user-{label}")
        cfg = load_config(MF_CHECKPOINT).replace(system={"root_dir": root, "save_mode": "per_user"})
        MatrixFactorization(cfg, device=where).load(MF_CHECKPOINT, data).test()
        (path,) = glob.glob(os.path.join(root, "results", "*_per_user.csv"))
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        tables.append((rows[0], np.array(rows[1:], dtype=np.float64)))
    (head, got), (_, want) = tables
    err = float(np.abs(got[:, 3] - want[:, 3]).max()) if len(got) == len(want) else np.inf
    if head != ["col_user", "col_item", "col_rating", "col_prediction"] or got.shape != want.shape \
            or not np.array_equal(got[:, :3], want[:, :3]) or err > PREDICT_TOL:
        fail(f"{phase}: the per-user file differs from the CPU's ({got.shape} vs {want.shape}, predictions by {err})")
    log(phase, f"save_mode per_user: {len(got)} rows, the CPU's users, items and relevance, predictions within "
        f"{err:.3g}")


def serving_surface(root_dir, device="cuda"):
    """Phase 34: the MF, LightGCN and SASRec checkpoints served on
    ``device`` through every recommend() route against the port on the CPU,
    the full-catalog evaluators against the JAX package's metrics,
    export_embeddings(), use_best both ways and the per-user file. Returns
    the kernels' counts on the path: the flash forward once a block for
    each of SASRec's score_all calls on the device, nothing else."""
    phase = "serving-surface"
    data, seq = mf_split(), seq_split()
    zero_kernel_counts()
    flash_expected = 0
    for name, (cls, path) in SERVING_FAMILY.items():
        d = seq if name == "SASRec" else data
        cfg = load_config(path).replace(system={"root_dir": root_dir})
        rec, cpu = cls(cfg, device=device).load(path, d), cls(cfg, device="cpu").load(path, d)
        calls = serve_routes(f"{phase}/{name}", rec, cpu, device)
        evaluated = evaluators_against_jax(f"{phase}/{name}", name, rec, device)
        if name == "SASRec":
            n_users, n_eval = d.n_users, len(eval_relevance(d)[0])
            flash_expected = rec.model.num_blocks * (calls * -(-n_users // 4096) + evaluated * -(-n_eval // 1024))
        else:
            log(f"{phase}/{name}", exported_tables(f"{phase}/{name}", rec, cpu, root_dir))
    serve_best_and_final(f"{phase}/use-best", data, root_dir, device)
    per_user_against_cpu(f"{phase}/per-user", data, root_dir, device)
    synchronize(device)
    counts = kernel_counts()
    if torch.device(device).type == "cuda":
        if counts["flash_causal_attention_fwd"] != flash_expected or any(
                v for key, v in counts.items() if key != "flash_causal_attention_fwd"):
            fail(f"{phase}: kernel launches {counts}, expected the flash forward {flash_expected} times alone")
        log(phase, f"flash forward launches on the path: {flash_expected} (= {flash_expected} expected: SASRec's "
            "score_all calls, a launch a block); no other kernel")
    return counts


def tie_matrix():
    """tests/test_torch_topk.py's tied scores: values on a 0.5 grid, a row
    of -0.0 with one +0.0, a row of NEG_INF and a row a third NEG_INF."""
    rng = np.random.default_rng(8)
    x = rng.integers(-3, 4, (64, 300)).astype(np.float32) * 0.5
    x[0] = -0.0
    x[0, 7] = 0.0
    x[1, :] = NEG_INF
    x[2, ::3] = NEG_INF
    return torch.from_numpy(x)


def total_order_ids(scores, k):
    """The plain version of topk_lowest_index: the ids of each row's k
    largest entries of a CPU tensor by a stable descending sort in
    ``lax.top_k``'s total order (-0.0 below +0.0)."""
    x = scores.double()
    x = torch.where((x == 0) & torch.signbit(x), torch.tensor(-1e-300, dtype=torch.float64), x)
    return torch.sort(x, dim=1, descending=True, stable=True).indices[:, :k]


def ties_on_device(phase, device, ks=(1, 7, 40, 300)):
    """topk_lowest_index on ``device`` over the tie matrix in float32 and
    bfloat16: the CPU's ids, values and signs, and the total-order sort's
    ids, exactly. Returns the cases held."""
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        x = tie_matrix().to(dtype)
        for k in ks:
            got_v, got_i = topk_lowest_index(x.to(device), k)
            want_v, want_i = topk_lowest_index(x, k)
            got_v = got_v.cpu()
            if not (torch.equal(got_i.cpu(), want_i) and torch.equal(want_i, total_order_ids(x, k))
                    and torch.equal(got_v, want_v) and torch.equal(torch.signbit(got_v), torch.signbit(want_v))):
                fail(f"{phase}: topk_lowest_index on the tie matrix ({dtype}, k {k}) is not the CPU's and the "
                     "total-order sort's")
            cases += 1
    return cases


def bf16_ties_exact(phase, u_emb, i_emb, excl, approx, k, cpu_users):
    """The bfloat16 route's tie order held exactly on the card's own
    scores: retrieval_topk's matmul for every user, the first ``cpu_users``
    rows copied to the CPU. topk_lowest_index of those rows on the device
    gives the total-order sort's k + T ids, and the approx route's ids for
    those users are the sort's top k with the excluded ids set to NEG_INF.
    Returns the rows whose (k+T)-th value ties an entry left out."""
    t = excl.shape[1]
    scores = u_emb.to(torch.bfloat16) @ i_emb.to(torch.bfloat16).T
    got = topk_lowest_index(scores[:cpu_users], k + t)[1].cpu()
    block = scores[:cpu_users].cpu()
    del scores
    if not torch.equal(got, total_order_ids(block, k + t)):
        fail(f"{phase}: topk_lowest_index on the card's bfloat16 scores is not the total-order sort's ids")
    kth = torch.topk(block.float(), k + t, dim=1).values[:, -1:]
    tied = int(((block.float() >= kth).sum(dim=1) > k + t).sum())
    block[torch.arange(cpu_users)[:, None], torch.as_tensor(excl[:cpu_users]).long()] = NEG_INF
    if not np.array_equal(approx[:cpu_users], total_order_ids(block, k).numpy()):
        fail(f"{phase}: the bfloat16 route's ids for the first {cpu_users} users are not the total-order sort's "
             "of the card's scores with the excluded ids masked")
    return tied


def retrieval_bound_ms(n_users, n_items, width, dtype):
    """(ms, "bytes" or "operations"): the score matrix written and read
    once against the matmul's operations at the card's peak for the type."""
    size = 2 if dtype == torch.bfloat16 else 4
    bytes_ms = 2 * n_users * n_items * size / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n_users * n_items * width / PEAK_FLOPS[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def retrieval_at_scale(seed, device="cuda", n_users=RETRIEVAL_SCALE["n_users"], n_items=RETRIEVAL_SCALE["n_items"],
                       emb_dim=RETRIEVAL_SCALE["emb_dim"], k=RETRIEVAL_SCALE["k"], t=RETRIEVAL_SCALE["t"],
                       cpu_users=RETRIEVAL_CPU_USERS, item_block=RETRIEVAL_ITEM_BLOCK):
    """Phase 35: bench_retrieval_scale's shape: MF tables from the
    initializer under ``seed``, ``t`` excluded ids a user from
    ``np.random.default_rng(0)`` (bench.py:423-425). Exact float32
    ``retrieval_topk`` gives a plain full sort's ids on the CPU for the
    first ``cpu_users`` users, ``streaming_topk`` exact's ids, and the
    bfloat16 scores ("approx") a top-k recall of at least RECALL_TARGET
    against exact; users/s of each route beside its bound, the peak device
    memory, and topk_lowest_index against a full sort. Returns the
    numbers."""
    from beta_recsys_tpu_torch.models.mf import MF

    phase = "retrieval-162k"
    model = MF({"emb_dim": emb_dim}, n_users, n_items, device=device).init_weights(torch.Generator().manual_seed(seed))
    u_emb, i_emb = (x.detach() for x in model.user_item_embeddings_trimmed())
    excl = np.random.default_rng(0).integers(0, n_items, (n_users, t)).astype(np.int32)
    ex = torch.as_tensor(excl, device=device)
    mask = torch.zeros((n_users, n_items), dtype=torch.bool, device=device)
    mask[torch.arange(n_users, device=device)[:, None], ex.long()] = True
    routes = {
        "exact float32": lambda: retrieval_topk(u_emb, i_emb, k, exclude_list=ex, mode="exact", score_dtype="float32"),
        "approx bfloat16": lambda: retrieval_topk(u_emb, i_emb, k, exclude_list=ex, mode="approx",
                                                  score_dtype="bfloat16"),
        f"streaming block {item_block}": lambda: streaming_topk(u_emb, i_emb, k, block=item_block, exclude_mask=mask),
    }
    out, ids = {}, {}
    for name, fn in routes.items():
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        (values, idx), secs = timed(fn, device)
        peak = torch.cuda.max_memory_allocated() / 2**30 if torch.device(device).type == "cuda" else None
        dtype = torch.bfloat16 if "bfloat16" in name else torch.float32
        bound, by = retrieval_bound_ms(n_users, n_items, u_emb.shape[1], dtype)
        ids[name] = idx.cpu().numpy()
        out[name] = {"users_per_s": n_users / secs, "ms": secs * 1e3, "bound_ms": bound, "bound_by": by,
                     "peak_gib": peak}
        if not torch.isfinite(values).all():
            fail(f"{phase}: {name} returned non-finite scores")
    exact, approx, stream = (ids[name] for name in routes)
    if (exact[:, :, None] == excl[:, None, :]).any() or (stream[:, :, None] == excl[:, None, :]).any():
        fail(f"{phase}: an excluded id was returned")
    u_cpu, i_cpu = u_emb[:cpu_users].cpu(), i_emb.cpu()
    scores = u_cpu @ i_cpu.T
    scores[torch.arange(cpu_users)[:, None], torch.as_tensor(excl[:cpu_users]).long()] = NEG_INF
    plain = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k].numpy()
    differ_cpu = same_ids(phase, "exact vs a full sort on the CPU", exact[:cpu_users], plain,
                          lambda rows, cols: np.take_along_axis(scores[rows].numpy(), cols, axis=1))

    def card_scores(rows, cols):
        r = torch.as_tensor(rows, device=device)
        return (u_emb[r][:, None, :] * i_emb[torch.as_tensor(cols, device=device)]).sum(-1).cpu().numpy()

    differ_stream = same_ids(phase, "streaming vs exact", stream, exact, card_scores)
    recall = float(np.mean([len(set(a) & set(e)) / k for a, e in zip(approx, exact)]))
    if recall < RECALL_TARGET:
        fail(f"{phase}: the bfloat16 scores' top-{k} recall against exact is {recall:.4f} < {RECALL_TARGET}")
    tied = bf16_ties_exact(phase, u_emb, i_emb, excl, approx, k, cpu_users)
    tie_cases = ties_on_device(phase, device)
    block = (u_emb[:2048] @ i_emb.T).contiguous()
    route_s = timed(lambda: topk_lowest_index(block, k + t), device)[1]
    sort_s = timed(lambda: torch.sort(block, dim=1, descending=True, stable=True), device)[1]
    out["topk_route_vs_sort_ms"] = (route_s * 1e3, sort_s * 1e3)
    out["recall"] = recall
    log(phase, f"{n_users} users x {n_items} items x d {u_emb.shape[1]}, k {k}, {t} excluded ids a user: "
        + "; ".join(f"{name} {r['users_per_s']:.1f} users/s ({r['ms']:.3f} ms, bound {r['bound_ms']:.3f} ms by "
                    f"{r['bound_by']}, peak {r['peak_gib'] if r['peak_gib'] is None else round(r['peak_gib'], 3)} "
                    "GiB)" for name, r in out.items() if isinstance(r, dict)))
    log(phase, f"exact ids = a full sort's on the CPU for the first {cpu_users} users ({differ_cpu} rows differ at "
        f"ties); streaming ids = exact's ({differ_stream} rows differ at ties); bfloat16 top-{k} recall {recall:.4f} "
        f"(>= {RECALL_TARGET}); topk_lowest_index(k {k + t}) on 2048 x {n_items} {route_s * 1e3:.3f} ms against a "
        f"full stable sort {sort_s * 1e3:.3f} ms")
    log(phase, f"bfloat16 tie order exact: on the card's scores of the first {cpu_users} users ({tied} of them tie at "
        f"the {k + t}-th value) topk_lowest_index and the bfloat16 route give the total-order sort's ids; the tie "
        f"matrix in {tie_cases} cases (float32 and bfloat16, k 1-300) gives the CPU's ids")
    return out


def engine_state(engine):
    """Everything a run carries from epoch to epoch, as tensors on the CPU:
    on a mesh also each table shard as it is placed."""
    out = {f"param/{k}": v.detach().cpu().clone() for k, v in engine.model.state_dict().items()}
    for name, st in engine._param_states().items():
        for key, value in (st or {}).items():
            out[f"opt/{name}/{key}"] = torch.as_tensor(value).cpu().clone()
    if engine.sparse_optim:
        out["sparse/step"] = torch.tensor(engine.epoch_fn.state["step"])
        for name, (m, v) in engine.epoch_fn.state["moments"].items():
            out[f"sparse/{name}/m"], out[f"sparse/{name}/v"] = m.cpu().clone(), v.cpu().clone()
    if engine.sharded:
        for name, shards in engine.epoch_fn.tables.items():
            for m, shard in enumerate(shards[0]):
                out[f"shard/{name}/{m}"] = shard.detach().cpu().clone()
    elif getattr(engine.epoch_fn, "dp", None) is not None:
        for name, shards in engine.epoch_fn.dp.tables.items():
            for m, shard in enumerate(shards):
                out[f"shard/{name}/{m}"] = shard.detach().cpu().clone()
    out["generator"] = engine.generator.get_state()
    bk = engine.bookkeeper
    out["bookkeeper"] = torch.tensor([bk.best_valid_performance, bk.best_epoch, bk.n_no_update], dtype=torch.float64)
    return out


def resume_repeats(phase, seed, root_dir, data, device="cuda", epochs=RESUME_EPOCHS, config=None, mesh_devices=None,
                   **model):
    """``epochs`` epochs, then a fresh engine's resume_training from their
    last/ for ``epochs`` more, equal to 2 * ``epochs`` straight epochs bit
    for bit: parameters, optimizer state, lazy-Adam moments and step,
    generator, bookkeeper and, on a mesh (``config``'s, over
    ``mesh_devices``), every table shard. Returns fused_rowadam's launches
    (one a step of the three runs)."""
    cfg = config or mf_config(seed, root_dir, **model)
    valid = data.eval_candidates(data.valid[0])

    def engine():
        built = build_model(cfg.model, data.n_users, data.n_items, {}, device)
        return TrainEngine(cfg, device, mesh_devices).build(built, data, valid)

    zero_kernel_counts()
    t0 = time.perf_counter()
    first = engine()
    first.train(max_epoch=epochs, verbose=False)
    resumed = engine()
    start = resumed.resume_training(first.checkpoint_dir)
    resumed.train(max_epoch=2 * epochs, verbose=False)
    straight = engine()
    straight.train(max_epoch=2 * epochs, verbose=False)
    synchronize(device)
    got, want = engine_state(resumed), engine_state(straight)
    differ = [key for key in want if key not in got or not torch.equal(got[key], want[key])]
    if start != epochs or differ or list(got) != list(want):
        fail(f"{phase}: resumed at {start}; the resumed run's state differs from the straight run's at {differ[:5]}")
    steps = 4 * epochs * straight.epoch_fn.num_batches
    launches = fused_rowadam.launches
    if torch.device(device).type == "cuda" and model.get("row_update") == "fused":
        check_launches("fused_rowadam", phase, launches, steps)
    kind = "lazy Adam" if straight.sparse_optim else "dense Adam"
    log(phase, f"{kind}: {epochs} epochs, then resume_training from last/ (start epoch {start}) for {epochs} more = "
        f"{2 * epochs} straight epochs bit for bit ({len(want)} tensors: parameters, optimizer state"
        f"{', moments, step' if straight.sparse_optim else ''}, generator, bookkeeper) in "
        f"{time.perf_counter() - t0:.2f} s")
    return launches


def jax_last_resumed(phase, root_dir, data, device="cuda"):
    """The JAX MF run's last/ (epoch 33, 20 epochs without a gain) resumed:
    the state equals the file's, the generator is seeded from its key data,
    and training stops after one epoch, as the JAX engine's does."""
    cfg = load_config(MF_CHECKPOINT).replace(system={"root_dir": root_dir})
    built = build_model(cfg.model, data.n_users, data.n_items, {}, device)
    engine = TrainEngine(cfg, device).build(built, data, data.eval_candidates(data.valid[0]))
    start = engine.resume_training(MF_CHECKPOINT)
    last = os.path.join(MF_CHECKPOINT, "last")
    raw, meta = load_raw_checkpoint(last), load_metadata(last)
    state = engine_state(engine)
    params = flatten_params(raw["params"])
    mu, nu = flatten_params(raw["opt_state"]["0"]["mu"]), flatten_params(raw["opt_state"]["0"]["nu"])
    count = int(raw["opt_state"]["0"]["count"])
    same = (all(torch.equal(state[f"param/{k}"], v) for k, v in params.items())
            and all(torch.equal(state[f"opt/{k}/exp_avg"], mu[k]) and torch.equal(state[f"opt/{k}/exp_avg_sq"], nu[k])
                    and int(state[f"opt/{k}/step"]) == count for k in params)
            and engine.bookkeeper.n_no_update == meta["n_no_update"] and start == meta["epoch"] + 1
            and engine.generator.initial_seed() == (int(raw["rng"][0]) << 32) | int(raw["rng"][1]))
    if not same:
        fail(f"{phase}: the resumed state is not the JAX last/ checkpoint's")
    engine.train(verbose=False)
    epochs = [h["epoch"] for h in engine.bookkeeper.history]
    if epochs != [start] or not engine.bookkeeper.should_stop:
        fail(f"{phase}: after resuming at {start} the run trained epochs {epochs}; the JAX engine stops after one")
    log(phase, f"the JAX MF last/ (epoch {meta['epoch']}, {meta['n_no_update']} epochs without a gain, Adam count "
        f"{count}) resumed: parameters, moments and count equal the file's, the generator seeded from its key "
        f"data; one epoch ({start}) trained, then the early stop, as in the JAX package")


def resume_phase(seed, root_dir, device="cuda", data=None, epochs=RESUME_EPOCHS):
    """Phase 36: resume_repeats for mf-sparse (fused_rowadam) and mf-dense,
    and jax_last_resumed, each its own path with the counts set to 0 before
    it. Returns the kernels' counts by path: fused_rowadam on mf-sparse's,
    nothing else anywhere."""
    data = data or mf_split()
    counts = {}
    resume_repeats("resume-mf-sparse", seed, root_dir, data, device, epochs, sparse_optim=True, row_update="fused")
    counts["resume-mf-sparse"] = kernel_counts()
    zero_kernel_counts()
    resume_repeats("resume-mf-dense", seed, root_dir, data, device, epochs)
    counts["resume-mf-dense"] = kernel_counts()
    zero_kernel_counts()
    jax_last_resumed("resume-jax-last", root_dir, data, device)
    counts["resume-jax-last"] = kernel_counts()
    for path, found in counts.items():
        extra = {k: v for k, v in found.items() if v and not (k == "fused_rowadam" and path == "resume-mf-sparse")}
        if extra:
            fail(f"{path}: launched {extra}; phase 36 runs fused_rowadam on mf-sparse alone")
    return counts


def serving_and_resume_phases(seed, root_dir):
    """Phases 34-36, each timed. Returns the kernels' counts by path."""
    counts, secs = {}, []
    t0 = time.perf_counter()
    counts["serving-surface"] = serving_surface(root_dir)
    secs.append(time.perf_counter() - t0)
    log("serving-surface", f"phase 34 took {secs[-1]:.2f} s")
    t0 = time.perf_counter()
    zero_kernel_counts()
    retrieval_at_scale(seed)
    counts["retrieval-162k"] = check_no_kernel("retrieval-162k")
    secs.append(time.perf_counter() - t0)
    log("retrieval-162k", f"phase 35 took {secs[-1]:.2f} s")
    t0 = time.perf_counter()
    counts.update(resume_phase(seed, root_dir))
    secs.append(time.perf_counter() - t0)
    log("resume", f"phase 36 took {secs[-1]:.2f} s; phases 34-36 {sum(secs):.2f} s")
    return counts


def on_mesh(config, mesh_shape):
    """``config`` on a ("data", "model") mesh of ``mesh_shape``."""
    return config.replace(system={"mesh": {"data": mesh_shape[0], "model": mesh_shape[1]}})


def mesh_engine(cls, config, data, device, devices):
    """(recommender, engine) built as ``cls(config, device, devices).train``
    builds them."""
    return built_engine(cls(config, device=device, mesh_devices=devices), data)


def counted(totals, fn):
    """``fn()`` with the kernels' counts from 0 around it, added to ``totals``."""
    zero_kernel_counts()
    out = fn()
    torch.cuda.synchronize()
    for key, value in kernel_counts().items():
        totals[key] = totals.get(key, 0) + value
    return out


def mesh_gaps(ref, engine):
    """The largest relative |d| between two engines' parameters (over
    max(1, |x|)) and optimizer moments (over the moment's largest |x|)."""
    for e in (ref, engine):
        if getattr(e.epoch_fn, "dp", None) is not None:
            e.epoch_fn.dp.assemble()
    theirs, ours = dict(ref.model.named_parameters()), dict(engine.model.named_parameters())
    gaps = {}
    for name, p in theirs.items():
        q = ours[name].detach().to(p.device)
        gaps[name] = float(((p.detach() - q).abs() / p.detach().abs().clamp(min=1)).max())
    want, got = ref._param_states(), engine._param_states()
    for name, state in want.items():
        for key in ("exp_avg", "exp_avg_sq", "nu"):
            if state and key in state:
                x, y = state[key], got[name][key].to(state[key].device)
                gaps[f"{name}.{key}"] = float((x - y).abs().max()) / max(float(x.abs().max()), 1e-30)
    return gaps


def epochs_within(path, ref, engine, epochs, totals):
    """``epochs`` epochs of ``engine`` (the path's, counted into ``totals``)
    and of ``ref`` on the batches ``engine`` forms and ``engine``'s draws and
    ReLU decisions (``DrawReplay``: a pre-activation within rounding of 0
    falls on either side on two devices, and one flip moves a whole row of
    gradient), each within MESH_TOL of the other (losses to 1e-5 relative).
    Returns the largest gap an epoch and the collectives of ``engine``'s
    runs."""
    worst, comms = [], {}
    for epoch, limit in zip(range(epochs), MESH_TOL):
        batches = engine.epoch_fn.form(engine.generator)
        with DrawReplay() as replay:
            with recording() as counts:
                got = float(counted(totals, lambda: engine.epoch_fn.run_batches(*batches,
                                                                                 generator=engine.generator)))
            replay.replaying = True
            want = float(ref.epoch_fn.run_batches(*(b.to(ref.device) for b in batches), generator=ref.generator))
            if replay.queue:
                fail(f"{path} epoch {epoch}: the reference took {len(replay.queue)} draws fewer than the mesh")
        for kind, entry in counts.items():
            comms.setdefault(kind, {"calls": 0, "bytes": 0})
            comms[kind]["calls"] += entry["calls"]
            comms[kind]["bytes"] += entry["bytes"]
        gaps = mesh_gaps(ref, engine)
        worst.append(max(gaps.values()))
        if abs(got - want) > 1e-5 * abs(want) or worst[-1] > limit:
            fail(f"{path} epoch {epoch}: loss {got} against {want}; largest relative |d| {worst[-1]} past {limit}: "
                 + ", ".join(f"{k} {v:.3g}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:4]))
    return worst, comms


def float_param_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters() if p.requires_grad and p.is_floating_point())


def check_one_allreduce(path, comms, steps, pbytes):
    """(f): one all-reduce a step of the float parameters' bytes (and the
    loss's), within 2%."""
    ar = comms.get("all_reduce", {"calls": 0, "bytes": 0})
    per_step = ar["bytes"] / max(ar["calls"], 1)
    if ar["calls"] != steps or not pbytes * 0.98 <= per_step <= pbytes * 1.02 + 64:
        fail(f"{path}: collectives {comms} over {steps} steps; expected one all-reduce a step of {pbytes} bytes")
    others = {k: v for k, v in comms.items() if k != "all_reduce"}
    log(path, f"collectives: {ar['calls']} all-reduces for {steps} steps, {per_step:.0f} bytes each = the float "
        f"parameters' {pbytes} bytes + {per_step - pbytes:.0f} (the loss); others {others or 'none'}")


def sasrec_on_meshes(seed, root_dir, data, devices, tag):
    """(a): SASRec at the checkpoint's config through SASRec(cfg,
    mesh_devices=...) on a (4, 1) mesh (2 epochs at dropout 0, each shard's
    flash forward and backward; trained twice, bit for bit), held
    within MESH_TOL of the port's own (4, 1) run on the CPU on the same
    batches, and at the shipped dropout its first SASREC_MESH_STEPS steps
    against the CPU's with the same draws (1e-5); then a (2, 2) mesh
    against the one-device trainer (the whole batch's loss: SASRec's
    (n_items + 1)-row table is not row-sharded, so no ring). Returns the
    kernels' counts by path."""
    counts = {}
    path = f"sasrec-mesh-4x1{tag}"
    zero_kernel_counts()
    cfg = on_mesh(sasrec_config(seed, root_dir, dropout_rate=0.0, max_epoch=DENSE_MESH_EPOCHS), (4, 1))
    rec, result, flash = train_sasrec(path, seed, root_dir, data, config=cfg, mesh_devices=devices)
    blocks = rec.model.num_blocks
    # train_sasrec sets the flash counts to 0: add the repeat's
    again, again_result, more = train_sasrec(f"{path}-repeat", seed, root_dir, data, config=cfg, mesh_devices=devices)
    for key in flash:
        flash[key] += more[key]
    same_sasrec_runs(path, [(rec, result), (again, again_result)])
    counts[path] = dict(kernel_counts(), flash_causal_attention_fwd=flash["steps"] + flash["eval"],
                        flash_causal_attention_bwd=flash["bwd"])
    log(path, f"{DENSE_MESH_EPOCHS} epochs on a (4, 1) mesh of {devices} through SASRec(cfg, mesh_devices).train("
        f"data), best valid ndcg@10 {result['valid_metric']:.6f}; a second training of the seed gave the same best "
        "and last parameters bit for bit")

    path = f"sasrec-mesh-4x1-vs-cpu{tag}"
    _, engine = mesh_engine(SASRec, cfg, data, None, devices)
    _, cpu = mesh_engine(SASRec, cfg, data, "cpu", ["cpu"] * 4)
    cpu.model.load_state_dict(engine.model.state_dict())
    totals = {}
    t0 = time.perf_counter()
    worst, comms = epochs_within(path, cpu, engine, DENSE_MESH_EPOCHS, totals)
    steps = DENSE_MESH_EPOCHS * engine.epoch_fn.num_batches
    for kernel in ("flash_causal_attention_fwd", "flash_causal_attention_bwd"):
        check_launches(kernel, path, totals[kernel], blocks * 4 * steps)
    counts[path] = totals
    log(path, f"{DENSE_MESH_EPOCHS} epochs ({steps} steps x {engine.epoch_fn.batch_size} sequences, 4 shards of "
        f"{engine.epoch_fn.batch_size // 4}) on the card and on a (4, 1) mesh of the CPU, same batches: largest "
        f"relative |d| per epoch " + ", ".join(f"{w:.3g}" for w in worst) + f" (limits {MESH_TOL[:len(worst)]}); "
        f"{time.perf_counter() - t0:.2f} s with the CPU's")
    check_one_allreduce(path, comms, steps, float_param_bytes(engine.model))

    path = f"sasrec-mesh-4x1-dropout{tag}"
    zero_kernel_counts()
    shipped = on_mesh(sasrec_config(seed, root_dir), (4, 1))
    start, engine = mesh_engine(SASRec, shipped, data, None, devices)
    diff, _, report = steps_match_cpu(path, start, engine, data, SASREC_MESH_STEPS, SSL_CPU_TOL, eps_set=SSL_EPS_SET,
                                      mesh_devices=["cpu"] * 4)
    torch.cuda.synchronize()
    counts[path] = kernel_counts()
    for kernel in ("flash_causal_attention_fwd", "flash_causal_attention_bwd"):
        check_launches(kernel, path, counts[path][kernel], blocks * 4 * SASREC_MESH_STEPS)
    log(path, f"{SASREC_MESH_STEPS} steps at the shipped dropout {shipped.model.dropout_rate} on a (4, 1) mesh (each "
        f"shard's own dropout seed from the step's generator state) equal the CPU's with the same draws: "
        + describe_steps(diff, SSL_CPU_TOL) + report)

    path = f"sasrec-mesh-2x2{tag}"
    cfg22 = on_mesh(sasrec_config(seed, root_dir, dropout_rate=0.0), (2, 2))
    _, engine = mesh_engine(SASRec, cfg22, data, None, devices)
    _, one = mesh_engine(SASRec, sasrec_config(seed, root_dir, dropout_rate=0.0), data, None, None)
    one.model.load_state_dict(engine.model.state_dict())
    totals = {}
    t0 = time.perf_counter()
    worst, comms = epochs_within(path, one, engine, DENSE_MESH_EPOCHS, totals)
    secs = time.perf_counter() - t0
    steps = DENSE_MESH_EPOCHS * engine.epoch_fn.num_batches
    for kernel in ("flash_causal_attention_fwd", "flash_causal_attention_bwd"):
        check_launches(kernel, path, totals[kernel], blocks * steps)
    if totals["ring_allgather"] or engine.epoch_fn.dp.tables:
        fail(f"{path}: SASRec's (n_items + 1)-row table was sharded or gathered ({totals})")
    counts[path] = totals
    log(path, f"{DENSE_MESH_EPOCHS} epochs on a (2, 2) mesh of {devices} (the whole batch's loss; no table of "
        f"n_users or n_items rows, so nothing row-sharded and no ring) against the one-device trainer on the same "
        f"batches: largest relative |d| per epoch " + ", ".join(f"{w:.3g}" for w in worst)
        + f"; collectives {comms or 'none'}; both runs {secs:.2f} s")
    return counts


def mf_on_meshes(seed, root_dir, data, sasrec_data, devices, tag):
    """(b), (c), (d): MF on the dense path on a (2, 2) mesh through
    MatrixFactorization(cfg, mesh_devices).train(data), item_emb (1,682 rows)
    row-sharded and gathered by the ring once a step, against the one-device
    dense trainer within MESH_TOL; NCF on a (4, 1) mesh against the port on
    a (4, 1) mesh of the CPU, same batches; the mesh's evaluators against
    one device's. Returns the kernels' counts by path."""
    counts = {}
    path = f"mf-dense-mesh-2x2{tag}"
    zero_kernel_counts()
    rec = MatrixFactorization(on_mesh(mf_config(seed, root_dir, sparse_optim=False, max_epoch=DENSE_MESH_EPOCHS),
                                      (2, 2)), mesh_devices=devices)
    with recording() as comms:
        result = rec.train(data)
    torch.cuda.synchronize()
    counts[path] = kernel_counts()
    ref = MatrixFactorization(mf_config(seed, root_dir, sparse_optim=False, max_epoch=DENSE_MESH_EPOCHS))
    ref.train(data)
    engine, trainer = rec.engine, rec.engine.epoch_fn
    for e in (engine, ref.engine):  # the final epoch's parameters, not the best ones train() left for serving
        e._restore_live()
    steps = DENSE_MESH_EPOCHS * trainer.num_batches
    cards = len(set(engine.mesh.devices[0]))  # one launch a card of data row 0 a call
    check_launches("ring_allgather", path, counts[path]["ring_allgather"], steps * len(trainer.dp.tables) * cards)
    gaps = mesh_gaps(ref.engine, engine)
    if max(gaps.values()) > MESH_TOL[DENSE_MESH_EPOCHS - 1]:
        fail(f"{path}: differs from the one-device dense trainer: {gaps}")
    ag = comms.get("all_gather", {"calls": 0, "bytes": 0})
    # The training steps gather the item table; the all-reduces are the
    # evaluators' metric sums over the 2 data shards, one an evaluation.
    evaluations = ((engine.valid_evaluator is not None) + (engine.test_evaluator is not None)) * DENSE_MESH_EPOCHS
    if (set(trainer.dp.tables) != {"item_emb"} or ag["calls"] != steps
            or comms.get("all_reduce", {}).get("calls", 0) != evaluations):
        fail(f"{path}: sharded {sorted(trainer.dp.tables)}, collectives {comms} over {steps} steps and "
             f"{evaluations} evaluations")
    rates = [trainer.padded_size / s for s in engine.epoch_seconds]
    log(path, f"{DENSE_MESH_EPOCHS} epochs of {trainer.num_batches} steps x {trainer.batch_size} on a (2, 2) mesh of "
        f"{devices}: item_emb ({data.n_items} rows) in 2 row shards, user_emb ({data.n_users} rows, under 1,024) "
        f"whole; against the one-device dense trainer: largest relative |d| {max(gaps.values()):.3g}; collectives: "
        f"{ag['calls']} all-gathers ({ag['bytes'] // max(ag['calls'], 1)} bytes each, the item table) and as many "
        f"reduce-scatters, no gradient all-reduce (the whole batch's loss on data row 0; {evaluations} all-reduces "
        f"of the evaluators' metric sums); examples/s per epoch "
        + ", ".join(f"{r:.0f}" for r in rates) + f"; best valid ndcg@10 {result['valid_metric']:.6f}")

    path = f"ncf-mesh-4x1{tag}"
    zero_kernel_counts()
    ncf = on_mesh(ncf_config("NCF", seed, root_dir), (4, 1))
    _, engine = mesh_engine(NeuCF, ncf, data, None, devices)
    _, cpu = mesh_engine(NeuCF, ncf, data, "cpu", ["cpu"] * 4)
    cpu.model.load_state_dict(engine.model.state_dict())
    totals = {}
    worst, comms = epochs_within(path, cpu, engine, 1, totals)
    counts[path] = check_no_kernel(path)
    check_one_allreduce(path, comms, engine.epoch_fn.num_batches, float_param_bytes(engine.model))
    log(path, f"1 epoch ({engine.epoch_fn.num_batches} steps x {engine.epoch_fn.batch_size} positives) on a (4, 1) "
        f"mesh of {devices} against a (4, 1) mesh of the CPU, same batches: largest relative |d| {worst[0]:.3g} "
        f"(limit {MESH_TOL[0]})")

    path = f"mesh-eval{tag}"
    zero_kernel_counts()
    valid = data.eval_candidates(data.valid[0])
    users, relevance = eval_relevance(data)
    sasrec = SASRec(sasrec_config(seed, root_dir)).load(CHECKPOINT, sasrec_data)
    blocks, gaps = sasrec.model.num_blocks, {}
    for name, model, d in (("MF", rec.model, data), ("SASRec", sasrec.model, sasrec_data)):
        cand = d.eval_candidates(d.valid[0]) if name == "SASRec" else valid
        u, r = (users, relevance) if name == "MF" else eval_relevance(d)
        mesh = make_mesh(2, 2, devices) if name == "MF" else make_mesh(4, 1, devices)
        pairs = ((RankingEvaluator(model, cand, mesh=mesh), RankingEvaluator(model, cand)),
                 (FullCatalogEvaluator(model, u, r, d.user_item_csr(), mesh=mesh),
                  FullCatalogEvaluator(model, u, r, d.user_item_csr())))
        for kind, (sharded, one) in zip(("ranking", "full-catalog"), pairs):
            got, want = sharded.evaluate(), one.evaluate()
            gap = max(abs(got[k] - want[k]) for k in want)
            if sorted(got) != sorted(want) or gap > MESH_EVAL_TOL:
                fail(f"{path}: {name}'s {kind} evaluation on the mesh differs from one device's by {gap}")
            gaps[f"{name} {kind} ({mesh.shape['data']} data shards)"] = gap
    torch.cuda.synchronize()
    counts[path] = kernel_counts()
    check_launches("flash forward", path, counts[path]["flash_causal_attention_fwd"], blocks * (4 + 1) * 2)
    log(path, "the mesh's evaluators against one device's (limit 1e-6): "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
    return counts


def mesh_resume(seed, root_dir, data, devices, tag):
    """(e): 1 + 1 resumed epochs equal 2 straight epochs bit for bit on the
    (1, 4) ring-lookup sparse mesh and the (2, 2) dense mesh, every table
    shard included. Returns the kernels' counts by path."""
    counts = {}
    n = len(data.train_arrays().users)
    for path, shape, cfg, tables in (
            # batches of 3,200 and 1,600 keep the 4 epochs short (at 400 a
            # ring-lookup epoch takes ~10 s on one card)
            (f"mesh-resume-sparse-1x4{tag}", (1, 4), mesh_config(seed, root_dir, (1, 4), batch_size=3200), 2),
            (f"mesh-resume-dense-2x2{tag}", (2, 2),
             on_mesh(mf_config(seed, root_dir, sparse_optim=False, batch_size=1600), (2, 2)), 1)):
        zero_kernel_counts()
        resume_repeats(path, seed, root_dir, data, devices[0], epochs=1, config=cfg, mesh_devices=devices)
        torch.cuda.synchronize()
        counts[path] = kernel_counts()
        mesh = make_mesh(*shape, devices)
        batch = cfg.model.batch_size // shape[0] * shape[0]
        # 4 epochs (1, 1 resumed, 2 straight); the sparse trainer's ring gathers
        # each table once a data row a step, the dense mesh each sharded table
        # once a step; one launch a card of data row 0.
        calls = tables * 4 * -(-n // batch) * (shape[0] if cfg.model.sparse_optim else 1)
        check_launches("ring_allgather", path, counts[path]["ring_allgather"], calls * len(set(mesh.devices[0])))
    return counts


def dense_mesh_phases(seed, root_dir):
    """Phase 37: the dense trainers, the evaluators and resume on meshes of
    ``["cuda:0"] * 4`` (and again on cuda:0-3 with 4 cards). Returns the
    kernels' counts by path."""
    t0 = time.perf_counter()
    data, sasrec_data = mf_split(), SequentialData(load_split_data(SPLIT, n_test=1))
    counts = {}
    layouts = [(["cuda:0"] * 4, "")]
    if torch.cuda.device_count() >= 4:
        layouts.append(([f"cuda:{i}" for i in range(4)], "-4cards"))
    for devices, tag in layouts:
        counts.update(sasrec_on_meshes(seed, root_dir, sasrec_data, devices, tag))
        counts.update(mf_on_meshes(seed, root_dir, data, sasrec_data, devices, tag))
        counts.update(mesh_resume(seed, root_dir, data, devices, tag))
    log("dense-mesh", f"phase 37 took {time.perf_counter() - t0:.2f} s")
    return counts


# -- mixed precision, the offline pipeline and the run layer (phase 38) ---------------


class _DtypeRecorder:
    """A flash wrapper that records the dtype of each call's q, calls the
    wrapper, and forwards its ``launches`` to the wrapper's own count."""

    def __init__(self, name, fn, seen):
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_seen", seen)

    def __call__(self, q, *args, **kwargs):
        self._seen[(self._name, str(q.dtype).replace("torch.", ""))] += 1
        return self._fn(q, *args, **kwargs)

    def __getattr__(self, key):
        return getattr(self._fn, key)

    def __setattr__(self, key, value):
        setattr(self._fn, key, value)


class FlashDtypes:
    """Inside the block, the dtypes each flash wrapper is called with, by
    kernel: the wrappers are wrapped where the autograd function finds them,
    and their launch counts stay their own."""

    def __enter__(self):
        self.seen = collections.Counter()
        self.real = {name: getattr(flash_attention_module, name)
                     for name in ("flash_causal_attention", "flash_causal_attention_bwd")}
        for name, fn in self.real.items():
            setattr(flash_attention_module, name, _DtypeRecorder(name, fn, self.seen))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(flash_attention_module, name, fn)


def only_bf16(phase, seen, kernels):
    """Fail unless every call of ``kernels`` in ``seen`` was bfloat16 and
    each was called."""
    for kernel in kernels:
        dtypes = {dtype: n for (name, dtype), n in seen.items() if name == kernel}
        if set(dtypes) != {"bfloat16"}:
            fail(f"{phase}: {kernel} ran in {dtypes}, not bfloat16 alone")


def median_rate(phase):
    rates = RATES[phase]
    return float(np.median(rates[1:] if len(rates) > 1 else rates))


def bf16_sasrec(seed, root_dir, gen):
    """Phase 38's SASRec: the kernels in bfloat16 at the training shape, the
    first steps against the CPU's, 2 epochs and test() against the CPU's.
    Returns (``train_sasrec``'s counts of the training, the kernels' counts
    of its test() by path, the timed bfloat16 row)."""
    phase = "sasrec-bf16"
    row = compare_flash_train(256, 100, 32, torch.bfloat16, DROPOUT_RATE, gen)
    timed = time_flash_train(256, 100, 32, torch.bfloat16, DROPOUT_RATE, gen)
    log(phase, f"256x100x32 bfloat16 at rate {DROPOUT_RATE}: forward |d| {row['max_abs_err']:.3g}, backward |d| "
        f"{row['bwd_max_abs_err']:.3g} (limits {TOL[torch.bfloat16]['out']}, {GRAD_TOL[torch.bfloat16]}), masks "
        "bit-equal to the plain mask")
    data = SequentialData(load_split_data(SPLIT, n_test=1))
    start, engine = built_engine(SASRec(sasrec_config(seed, root_dir, compute_dtype="bfloat16")), data)
    diff, _, eps_set = steps_match_cpu(phase, start, engine, data, BF16_STEPS, BF16_TOL)
    log(phase, f"{BF16_STEPS} Adam steps in bfloat16 from the initial weights equal the CPU's bfloat16 steps on the "
        f"same batches, dropout masks and ReLU decisions: {describe_steps(diff, BF16_TOL)}{eps_set}")
    counts = {}
    with FlashDtypes() as dtypes:
        rec, result, train_counts = train_sasrec(phase, seed, root_dir, data, compute_dtype="bfloat16",
                                                 max_epoch=BF16_SASREC_EPOCHS)
        zero_kernel_counts()
        res = rec.test()
        torch.cuda.synchronize()
        counts[f"{phase}-test"] = kernel_counts()
    only_bf16(phase, dtypes.seen, ("flash_causal_attention", "flash_causal_attention_bwd"))
    if any(p.dtype != torch.float32 for p in rec.model.parameters()):
        fail(f"{phase}: a parameter left float32")
    cpu = SASRec(rec.config, device="cpu").load(result["model_save_dir"], data)
    want = cpu.test()
    gap = max(abs(res[key] - want[key]) for key in want)
    if gap > BF16_TEST_TOL:
        fail(f"{phase}: test() on the card differs from the CPU's by {gap} (limit {BF16_TEST_TOL})")
    bf16, f32 = median_rate(phase), median_rate("sasrec-train")
    log(phase, f"flash calls by dtype {dict(dtypes.seen)}; sequences/s {bf16:.1f} in bfloat16 against "
        f"{f32:.1f} in float32 (phase 8, this call): {bf16 / f32:.3f}x; test() within {gap:.3g} of the CPU's "
        f"bfloat16 test(): " + ", ".join(f"{k} {res[k]:.6f}" for k in EXPECTED_METRICS))
    return train_counts, counts, timed


def bf16_mf(seed, root_dir):
    """Phase 38's MF: lazy Adam in bfloat16 through fused_rowadam. Returns
    the kernels' counts on its path."""
    phase = "mf-bf16"
    zero_kernel_counts()
    rec, result, launches, res = train_mf(phase, seed, root_dir, sparse_optim=True, row_update="fused",
                                          compute_dtype="bfloat16", max_epoch=MF_BF16_EPOCHS)
    steps = len(rec.engine.bookkeeper.history) * rec.engine.epoch_fn.num_batches
    check_launches("fused_rowadam", phase, launches, steps)
    moments = [t for pair in rec.engine.epoch_fn.state["moments"].values() for t in pair]
    if any(t.dtype != torch.float32 for t in [*rec.model.parameters(), *moments]):
        fail(f"{phase}: a parameter or moment left float32")
    bf16, f32 = median_rate(phase), median_rate("mf-sparse")
    log(phase, f"(cap {MF_BF16_EPOCHS} epochs) " + in_band("best valid ndcg@10", result["valid_metric"],
                                                           MF_BF16_BAND["valid"])
        + "; " + band_position("test ndcg@10", res["ndcg@10"], MF_BF16_BAND["test"])
        + f"; examples/s {bf16:.1f} in bfloat16 against {f32:.1f} in float32 (phase 3, this call): "
        f"{bf16 / f32:.3f}x")
    return {f"{phase}-train": {**kernel_counts(), "fused_rowadam": launches}}


def pipeline_and_run_layer(seed, root_dir, device="cuda"):
    """Phase 38's host side: the pipeline regenerates the committed split on
    this host (no pandas here), the train_model CLI runs on ``device`` in a
    subprocess, and model.tune trains mf_default.json's grid there. Returns
    the kernels' counts by path."""
    phase = "pipeline"
    t0 = time.perf_counter()
    lib, secs = host.build()
    log(phase, f"host library {os.path.relpath(lib, REPO)} built by g++ in {secs:.2f} s")
    committed = os.path.join(REPO, "datasets", "synthetic_structured", "processed")
    with tempfile.TemporaryDirectory() as tmp:
        np.random.seed(seed)
        dataset = SyntheticStructured(root_dir=tmp)
        dataset.make_leave_one_out(n_negative=100, n_test=1)
        files = ["synthetic_structured_interaction.npz"] + [f"leave_one_out/full_n_neg_100/{name}.npz"
                                                           for name in ("train", "valid", "test")]
        for rel in files:
            with np.load(os.path.join(committed, rel)) as want, \
                    np.load(os.path.join(dataset.processed_path, rel)) as got:
                if list(want.keys()) != list(got.keys()) or any(
                        want[k].dtype != got[k].dtype or want[k].shape != got[k].shape
                        or not np.array_equal(want[k], got[k]) for k in want):
                    fail(f"{phase}: the regenerated {rel} differs from the committed file")
    log(phase, f"{', '.join(files)} regenerated equal to the committed files, array for array "
        f"({time.perf_counter() - t0:.2f} s with the build)")

    counts = {}
    phase = "cli"
    t0 = time.perf_counter()
    zero_kernel_counts()
    cmd = [sys.executable, "-m", "beta_recsys_tpu_torch.cli.train_model", "--model", "mf", "--max_epoch", "1",
           "--dataset", "synthetic_structured", "--n_test", "1", "--root_dir", root_dir, "--device", device]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    result_csv = os.path.join(root_dir, "results", "mf_result.csv")
    if out.returncode != 0 or not os.path.exists(result_csv) or "test result:" not in out.stdout:
        fail(f"{phase}: train_model exited {out.returncode}: {out.stderr[-2000:]}")
    with open(result_csv) as f:
        rows = list(csv.DictReader(f))
    log(phase, f"python -m beta_recsys_tpu_torch.cli.train_model --model mf --max_epoch 1 --device {device}: exit 0 in "
        f"{time.perf_counter() - t0:.2f} s, {os.path.relpath(result_csv, root_dir)} row ndcg@10 "
        f"{float(rows[-1]['ndcg@10']):.6f}")

    phase = "tune"
    t0 = time.perf_counter()
    zero_kernel_counts()
    cfg = mf_config(seed, root_dir, max_epoch=1, tune=True)
    result = MatrixFactorization(cfg, device=device).train(mf_split())
    torch.cuda.synchronize()
    counts[phase] = kernel_counts()
    grid = result["tune_result"]
    table = os.path.join(root_dir, cfg.system.get("tune_dir", "tune_results/"), "tune_result.csv")
    if len(grid) != len(cfg.tunable[0]["values"]) or not os.path.exists(table):
        fail(f"{phase}: {len(grid)} trials for the grid {cfg.tunable}, table {os.path.exists(table)}")
    log(phase, f"model.tune over {[dict(t) for t in cfg.tunable]} at max_epoch 1 on {device}, in turn: "
        + ", ".join(f"{r['loss']} valid ndcg@10 {r['valid_metric']:.6f}" for r in grid)
        + f"; tune_result.csv written ({time.perf_counter() - t0:.2f} s)")
    return counts


def mixed_precision_phases(seed, root_dir, gen):
    """Phase 38. Returns (the bfloat16 SASRec training's flash counts, the
    kernels' counts by path, the timed bfloat16 flash row at the training
    shape)."""
    t0 = time.perf_counter()
    train_counts, counts, timed = bf16_sasrec(seed, root_dir, gen)
    counts.update(bf16_mf(seed, root_dir))
    counts.update(pipeline_and_run_layer(seed, root_dir))
    log("mixed-precision", f"phase 38 took {time.perf_counter() - t0:.2f} s")
    return train_counts, counts, timed


# -- the raw-file adapters behind the shipped configs (phase 39) -------------------------

# Phase 39 writes raw files at their datasets' published shapes, from the
# seed, and runs each shipped config's split from them on the host. ml-100k:
# 943 users, 1,682 items, 100,000 ratings, at least 20 a user, zipf item
# popularity. Dunnhumby: the published 2,500 households, 3-9 baskets each
# over 20,000 products (the real file's 2.6 M rows cut to ~85,000). Ta-Feng: digit-string ids as the real file's,
# 500 customers over 2,500 products (the real 32,266 and 23,812 cut: its
# split writes 20 copies of 101 string ids a customer).
ML100K_SHAPE = {"n_users": 943, "n_items": 1682, "n_ratings": 100_000, "min_per_user": 20}
DUNNHUMBY_SHAPE = {"n_households": 2_500, "n_products": 20_000, "baskets": (3, 10), "basket_size": (1, 12)}
TAFENG_SHAPE = {"n_users": 500, "n_products": 2_500, "baskets": (2, 9), "basket_size": (1, 10)}
RAW_SHAPES = {"ml_100k": ML100K_SHAPE, "dunnhumby": DUNNHUMBY_SHAPE, "tafeng": TAFENG_SHAPE}
# Each dataset's shipped config (its dataset section is the config's own).
RAW_CONFIGS = {"ml_100k": "configs/mf_default.json", "dunnhumby": "configs/triple2vec_default.json",
               "tafeng": "configs/ultragcn_default.json"}
RAW_MF_EPOCHS = 3  # phase 39's training of mf_default.json on the hand-placed u.data
RANDOM_NDCG = 0.045  # ndcg@10 of a random ranking of 1 positive among 101 candidates
OCCUPATIONS = ("administrator", "artist", "doctor", "educator", "engineer", "entertainment", "executive",
               "healthcare", "homemaker", "lawyer", "librarian", "marketing", "none", "other", "programmer",
               "retired", "salesman", "scientist", "student", "technician", "writer")


def _write_lines(path, lines, encoding="utf-8"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding=encoding, newline="") as f:
        f.write("".join(line + "\n" for line in lines))


def write_ml100k_raw(raw_path, seed, n_users, n_items, n_ratings, min_per_user):
    """ml-100k's three files under ``raw_path/ml-100k/`` (as its zip
    unpacks): u.data (user, item, rating 1-5, timestamp; tab-separated, in
    no order), u.item (latin-1, 24 "|"-separated fields: id, title, dates,
    url, 19 genre flags) and u.user (id, age, gender, occupation, zip). The
    ratings follow the structured generator's users, items and time order,
    topped up to ``n_ratings`` distinct pairs."""
    frame = generate_structured_data(n_users=n_users, n_items=n_items, n_interactions=n_ratings,
                                     min_per_user=min_per_user, seed=seed)
    rng = np.random.default_rng(seed)
    users, items = frame[DEFAULT_USER_COL], frame[DEFAULT_ITEM_COL]  # in time order
    seen = set(zip(users.tolist(), items.tolist()))
    extra = []  # the generator's rounding leaves a few short: new pairs, by popularity, at random times
    while len(seen) < n_ratings:
        pair = (int(rng.integers(0, n_users)), int(min(rng.zipf(1.3), n_items) - 1))
        if pair not in seen:
            seen.add(pair)
            extra.append(pair)
    when = np.argsort(np.r_[np.arange(len(users)), rng.uniform(0, len(users), len(extra))], kind="stable")
    users = np.r_[users, [u for u, _ in extra]].astype(np.int64)[when]
    items = np.r_[items, [i for _, i in extra]].astype(np.int64)[when]
    n = len(users)
    stamps = 874724710 + np.cumsum(rng.integers(1, 200, n))
    rows = np.stack([users + 1, items + 1, rng.integers(1, 6, n), stamps], 1)
    base = os.path.join(raw_path, "ml-100k")
    _write_lines(os.path.join(base, "u.data"), ["\t".join(map(str, r)) for r in rows[rng.permutation(n)].tolist()])
    genres = np.where(rng.random((n_items, 19)) < 0.12, "1", "0")
    _write_lines(os.path.join(base, "u.item"), [
        f"{i + 1}|{'Café' if i % 7 == 0 else 'Film'} {i + 1} (199{i % 10})|01-Jan-199{i % 10}||"
        f"http://us.imdb.com/M/title-exact?Film%20{i + 1}|" + "|".join(genres[i]) for i in range(n_items)],
        encoding="latin-1")
    ages, zips = rng.integers(7, 74, n_users), rng.integers(0, 99999, n_users)
    gender = np.where(rng.random(n_users) < 0.29, "F", "M")
    occupation = rng.permutation(np.arange(n_users) % len(OCCUPATIONS))  # each one held by someone
    _write_lines(os.path.join(base, "u.user"), [f"{u + 1}|{ages[u]}|{gender[u]}|{OCCUPATIONS[occupation[u]]}|"
                                                f"{zips[u]:05d}" for u in range(n_users)])
    return n


def _baskets(rng, n_users, n_products, baskets, basket_size, groups=20):
    """(user, basket index, product) rows: zipf product popularity, each
    user shopping mostly in two of ``groups`` departments."""
    pop = 1.0 / (rng.permutation(n_products) + 1.0) ** 1.1
    dept = rng.permutation(np.arange(n_products) % groups)  # no department empty
    by_dept = [np.flatnonzero(dept == g) for g in range(groups)]
    probs = [pop[idx] / pop[idx].sum() for idx in by_dept]
    n_baskets = rng.integers(*baskets, n_users)
    users = np.repeat(np.arange(n_users), n_baskets)
    sizes = rng.integers(*basket_size, len(users))
    row_user, row_basket = np.repeat(users, sizes), np.repeat(np.arange(len(users)), sizes)
    home = rng.integers(0, groups, (n_users, 2))
    row_dept = np.where(rng.random(len(row_user)) < 0.8, home[row_user, rng.integers(0, 2, len(row_user))],
                        rng.integers(0, groups, len(row_user)))
    products = np.empty(len(row_user), dtype=np.int64)
    for g in range(groups):
        rows = np.flatnonzero(row_dept == g)
        products[rows] = rng.choice(by_dept[g], size=len(rows), p=probs[g])
    return row_user, row_basket, products


def write_dunnhumby_raw(raw_path, seed, n_households, n_products, baskets, basket_size):
    """transaction_data.csv with The Complete Journey's twelve columns: each
    household's baskets on increasing days (DAY 1-711), TRANS_TIME as an
    un-padded HHMM int."""
    rng = np.random.default_rng(seed)
    user, basket, product = _baskets(rng, n_households, n_products, baskets, basket_size)
    n_b = basket.max() + 1
    basket_user = np.zeros(n_b, dtype=np.int64)
    basket_user[basket] = user
    day = np.zeros(n_b, dtype=np.int64)
    for h in range(n_households):  # each household's days increase
        own = np.flatnonzero(basket_user == h)
        day[own] = np.sort(rng.integers(1, 712, len(own)))
    trans_time = rng.integers(0, 24, n_b) * 100 + rng.integers(0, 60, n_b)
    basket_id = 26984851472 + np.cumsum(rng.integers(1, 300, n_b))
    header = ("household_key,BASKET_ID,DAY,PRODUCT_ID,QUANTITY,SALES_VALUE,STORE_ID,RETAIL_DISC,TRANS_TIME,"
              "WEEK_NO,COUPON_DISC,COUPON_MATCH_DISC")
    lines = [f"{u + 1},{basket_id[b]},{day[b]},{p + 25671},1,{(p % 500) / 100 + 0.39:.2f},364,-0.6,{trans_time[b]},"
             f"{day[b] // 7 + 1},0,0" for u, b, p in zip(user.tolist(), basket.tolist(), product.tolist())]
    _write_lines(os.path.join(raw_path, "transaction_data.csv"), [header] + lines)
    return len(lines)


def write_tafeng_raw(raw_path, seed, n_users, n_products, baskets, basket_size):
    """train.txt and test.txt, one basket a line: order id, products, customer
    id and date (2000-11-01 to 2001-02-28), tab-separated, digit-string ids
    as the real file's; each customer's last basket goes to test.txt."""
    rng = np.random.default_rng(seed)
    user, basket, product = _baskets(rng, n_users, n_products, baskets, basket_size)
    customers = [f"{c:08d}" for c in rng.choice(20_000_000, n_users, replace=False)]
    codes = [f"47{c:011d}" for c in rng.choice(10**11, n_products, replace=False)]
    n_b = basket.max() + 1
    basket_user = np.zeros(n_b, dtype=np.int64)
    basket_user[basket] = user
    days = np.datetime64("2000-11-01") + rng.integers(0, 120, n_b)
    order_ids = 1_000_000 + np.arange(n_b)
    starts = np.searchsorted(basket, np.arange(n_b))
    ends = np.searchsorted(basket, np.arange(n_b), "right")
    last = np.r_[basket_user[1:] != basket_user[:-1], True]  # baskets come user by user
    out = {"train.txt": [], "test.txt": []}
    for b in range(n_b):
        items = "\t".join(codes[p] for p in product[starts[b]:ends[b]])
        out["test.txt" if last[b] else "train.txt"].append(
            f"{order_ids[b]}\t{items}\t{customers[basket_user[b]]}\t{days[b]}")
    for name, lines in out.items():
        _write_lines(os.path.join(raw_path, name), lines)
    return len(product)


RAW_WRITERS = {"ml_100k": write_ml100k_raw, "dunnhumby": write_dunnhumby_raw, "tafeng": write_tafeng_raw}


def raw_config(name, seed, root_dir, **model):
    """The dataset's shipped config with its datasets, runs and results under
    ``root_dir`` and the run's seed."""
    return load_config(os.path.join(REPO, RAW_CONFIGS[name])).replace(
        system={"root_dir": root_dir, "seed": seed}, dataset={"root_dir": root_dir}, model=model)


def preprocessed(name, seed, root_dir, shape):
    """Write the raw files into a fresh ``root_dir`` and preprocess them:
    (the adapter, seconds to preprocess, the interaction npz's bytes)."""
    dataset = build_dataset(raw_config(name, seed, root_dir).to_dict())
    RAW_WRITERS[name](dataset.raw_path, seed, **shape)
    t0 = time.perf_counter()
    dataset.preprocess()
    secs = time.perf_counter() - t0
    with open(dataset.interaction_file(), "rb") as f:
        return dataset, secs, f.read()


def raw_split(name, seed, root_dir, shape=None, **model):
    """One dataset's path on the host: raw files -> load_split_dataset (its
    preprocess, k-core and the config's split, on a miss), and the same raw
    files preprocessed again in a fresh directory, byte for byte. Returns
    (config, split)."""
    phase = f"raw-{name}"
    shape = shape or RAW_SHAPES[name]
    config = raw_config(name, seed, os.path.join(root_dir, name, "a"), **model)
    dataset = build_dataset(config.to_dict())
    t0 = time.perf_counter()
    n_raw = RAW_WRITERS[name](dataset.raw_path, seed, **shape)
    t_write = time.perf_counter() - t0
    np.random.seed(seed)
    t0 = time.perf_counter()
    split = load_split_dataset(config.to_dict())
    t_load = time.perf_counter() - t0
    again, t_pre, again_bytes = preprocessed(name, seed, os.path.join(root_dir, name, "b"), shape)
    with open(dataset.interaction_file(), "rb") as f:
        if f.read() != again_bytes:
            fail(f"{phase}: a second preprocess of the same raw files wrote other bytes to "
                 f"{os.path.basename(again.interaction_file())}")
    before = len(get_dataframe_from_npz(dataset.interaction_file())[DEFAULT_USER_COL])
    after = len(dataset.load_interaction()[DEFAULT_USER_COL])
    train, valid, test = split
    ds = config.dataset
    if len(valid) != ds["n_test"] or len(test) != ds["n_test"] or not len(train[DEFAULT_USER_COL]):
        fail(f"{phase}: {len(valid)} valid and {len(test)} test copies, {len(train[DEFAULT_USER_COL])} train rows")
    for frame in (*valid, *test):
        if frame[DEFAULT_ITEM_COL].dtype.kind != train[DEFAULT_ITEM_COL].dtype.kind:
            fail(f"{phase}: evaluation items of dtype {frame[DEFAULT_ITEM_COL].dtype}, train's "
                 f"{train[DEFAULT_ITEM_COL].dtype}")
    log(phase, f"{RAW_CONFIGS[name]} ({ds['data_split']}, {ds['n_test']} copies of {ds['n_negative']} negatives): "
        f"{n_raw} raw rows written in {t_write:.2f} s; preprocess {t_pre:.2f} s (a second run in a fresh directory: "
        f"the same bytes); load_split_dataset (preprocess, k-core, split) {t_load:.2f} s, so the split "
        f"{t_load - t_pre:.2f} s; rows {before} before the k-core (min_i_c {dataset.min_i_c}), {after} after; "
        f"{len(train[DEFAULT_USER_COL])} train rows")
    return config, split


def raw_adapters_phase(seed, root_dir, device="cuda", shapes=None, epochs=RAW_MF_EPOCHS):
    """Phase 39: ml_100k from a hand-placed u.data through mf_default.json
    (lazy Adam: fused_rowadam once a step) to test(), its feature vectors,
    and the dunnhumby and Ta-Feng configs' splits on the host. Returns the
    kernels' counts by path."""
    t0 = time.perf_counter()
    shapes = shapes or RAW_SHAPES
    phase = "raw-ml_100k"
    # mf_default.json's sparse_optim is "auto", which trains on the dense
    # path on one device; true takes the lazy-Adam path of phase 3.
    config, split = raw_split("ml_100k", seed, root_dir, shapes["ml_100k"], max_epoch=epochs, sparse_optim=True)
    dataset = build_dataset(config.to_dict())
    user_feat, item_feat = dataset.make_fea_vec()
    shape = shapes["ml_100k"]
    if user_feat.shape != (shape["n_users"], 1 + 8 + 2 + len(OCCUPATIONS)) or item_feat.shape != (shape["n_items"], 20):
        fail(f"{phase}: make_fea_vec gave {user_feat.shape} and {item_feat.shape}")
    t1 = time.perf_counter()
    data = BaseData(split)
    t_data = time.perf_counter() - t1
    zero_kernel_counts()
    rec = MatrixFactorization(config, device=device)
    t1 = time.perf_counter()
    result = rec.train(data)
    synchronize(device)
    t_train = time.perf_counter() - t1
    counts = kernel_counts()
    engine = rec.engine
    steps = len(engine.bookkeeper.history) * engine.epoch_fn.num_batches
    if device == "cuda":
        check_launches("fused_rowadam", phase, counts["fused_rowadam"], steps)
    if any(v for k, v in counts.items() if k != "fused_rowadam"):
        fail(f"{phase}: launched {counts}; the path runs fused_rowadam alone")
    t1 = time.perf_counter()
    res = rec.test()
    t_test = time.perf_counter() - t1
    rates = RATES[phase] = [engine.epoch_fn.padded_size / s for s in engine.epoch_seconds]
    if not res["ndcg@10"] > RANDOM_NDCG:
        fail(f"{phase}: test ndcg@10 {res['ndcg@10']:.6f}, not above random ranking ({RANDOM_NDCG})")
    log(phase, f"make_fea_vec: user_feat {user_feat.shape}, item_feat {item_feat.shape}; BaseData {t_data:.2f} s; "
        f"MatrixFactorization(mf_default.json).train() {t_train:.2f} s (its evaluations included), test() "
        f"{t_test:.2f} s: {data.n_users} users, {data.n_items} items, {len(rates)} epochs of "
        f"{engine.epoch_fn.num_batches} steps x {engine.epoch_fn.batch_size}, examples/s per epoch "
        + ", ".join(f"{r:.1f}" for r in rates) + f"; best valid ndcg@10 {result['valid_metric']:.6f}; test() "
        + ", ".join(f"{k} {res[k]:.6f}" for k in ("ndcg@10", "recall@10", "precision@10", "map@10"))
        + f" (random ranking {RANDOM_NDCG})")
    for name in ("dunnhumby", "tafeng"):
        _, split = raw_split(name, seed, root_dir, shapes[name])
        held = BaseData(split)
        if not all(len(f[DEFAULT_USER_COL]) for f in (*held.valid, *held.test)):
            fail(f"raw-{name}: BaseData kept no evaluation row of a copy")
    log("raw-adapters", f"phase 39 took {time.perf_counter() - t0:.2f} s")
    return {"raw-ml_100k-train": counts}


# -- the lazy-Adam trainer's packed row layouts (phase 40) -----------------------------

LAYOUTS = ("unified", "compact", "unified_bf16")
# (mean, sample std) of best valid and test ndcg@10 over seeds 0-9 of the JAX
# package's MF + BPR lazy-Adam training under each layout, read at
# MF_SPARSE_EPOCHS: "unified" and "compact" (at its default capacity, which
# dropped nothing in any seed: JAX_COMPACT_DROPPED) follow "xla"'s trajectory
# up to float reassociation, so SPARSE_BAND_AT_CAP holds them ("compact"'s
# own ten seeds at cap 5: 0.189701 +- 0.004629, 0.166553 +- 0.007077);
# "unified_bf16" rounds its moments to bfloat16 and has its own band,
# `JAX_PLATFORMS=cpu python port_tools/jax_mf_band.py --row_update
# unified_bf16`.
LAYOUT_BF16_BAND = {"valid": (0.19093503803014755, 0.005643520068059012),
                    "test": (0.17053362876176834, 0.007207951757423642)}
JAX_COMPACT_DROPPED = 0  # seed 0's dropped count at the default capacity: `jax_mf_band.py --row_update compact`
COMPACT_STARVED = 16  # a capacity far below a step's ~1,000 unique ids: every step drops rows
# The packed write's shapes: MF's step (the structured split's tables, emb 64
# and a bias column, L = 3B ids at mf_default.json's B 400, the layout
# trainings' batch) and a table-scale step (bench.py's bench_sparse_large
# tables, zipf ids, B 16,384).
PACKED_MF_STEP = {"n_users": 943, "n_items": 1682, "emb_dim": 64, "batch": 400, "zipf": False}
PACKED_SCALE = {"n_users": 1_000_000, "n_items": 100_000, "emb_dim": 64, "batch": 16_384, "zipf": True}
# "compact"'s cut at table scale: below the ~11,700 distinct ids of a zipf
# step (11,671 at seed 1, phase 40's), so ~3,500 first occurrences lose
# their gradient.
PACKED_SCALE_CAPACITY = 8192
# The same step with uniform ids (bench.py's bench_sparse_large default):
# nearly every id distinct, so each warp of the packed kernel stages its
# rows in more than one round.
PACKED_SCALE_UNIFORM = {**PACKED_SCALE, "zipf": False}


def layout_band(layout):
    return LAYOUT_BF16_BAND if layout == "unified_bf16" else SPARSE_BAND_AT_CAP


def packed_layout(n_users, n_items, d, bf16):
    """MF's ``PackedRows``: user_emb and user_bias side by side in the users'
    rows, item_emb and item_bias in the items' (the embeddings alone under
    the bfloat16 form)."""
    roles = {"users": [("user_emb", d, 2), ("user_bias", 1, 1)], "items_cat": [("item_emb", d, 2), ("item_bias", 1, 1)]}
    if bf16:
        roles = {role: specs[:1] for role, specs in roles.items()}
    return PackedRows(roles, {"users": n_users, "items_cat": n_items})


def packed_inputs(n_users, n_items, emb_dim, batch, zipf, seed, bf16, device="cuda"):
    """(layout, packed array, sorted packed ids, their deduplicated gradient
    rows) for one MF step on ``device``: random tables and moments, B user
    ids and 2B item ids (zipf-distributed or uniform), every 7th gradient row
    zero."""
    rng = np.random.default_rng(seed)
    layout = packed_layout(n_users, n_items, emb_dim, bf16)
    gen = torch.Generator(device=device).manual_seed(seed)
    params, moments = {}, {}
    for name, nd, _, n, _, w in layout.columns:
        shape = (n, w) if nd == 2 else (n,)
        params[name] = torch.randn(shape, generator=gen, device=device)
        moments[name] = (0.1 * torch.randn(shape, generator=gen, device=device),
                         (0.1 * torch.randn(shape, generator=gen, device=device)).abs())
    packed = (layout.pack16 if bf16 else layout.pack)(params, moments)

    def draw(n, size):
        return (rng.zipf(1.2, size) - 1) % n if zipf else rng.integers(0, n, size)

    role_ids = {"users": torch.as_tensor(draw(n_users, batch), device=device),
                "items_cat": torch.as_tensor(draw(n_items, 2 * batch), device=device)}
    ids, _ = layout.ids(role_ids)
    grads = torch.randn(ids.shape[0], layout.w, generator=gen, device=device)
    grads[::7] = 0.0
    return (layout, packed, *_segment_dedup(ids, grads))


def packed_bound(touched, w, n_ids, bf16):
    """(bound_ms, bound_by) of one packed write: each touched row reads and
    writes its [param|m|v] (3w float32) or [p_hi|p_lo|m|v] (4w uint16) row,
    every gradient row (w float32) and id (8 bytes) is read once; ~14 FLOPs
    a touched element over the float32 peak."""
    row_bytes = 2 * 4 * w * 2 if bf16 else 6 * w * 4
    nbytes = touched * row_bytes + n_ids * (w * 4 + 8)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 14 * touched * w / PEAK_FLOPS[torch.float32] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def packed_read_bound(first, touched, w, n_ids, bf16):
    """The bound of what a write needs that reads no duplicate's gradient
    row (the call's contract makes them zero): every id, the ``first``
    occurrences' gradient rows and each touched row read and written, over
    the memory rate (bytes bind it at every shape here)."""
    row_bytes = 2 * 4 * w * 2 if bf16 else 6 * w * 4
    return (touched * row_bytes + first * w * 4 + n_ids * 8) / HBM_BYTES_PER_S * 1e3


def first_occurrences(ids):
    """The number of distinct ids in a sorted id array."""
    return int((ids[1:] != ids[:-1]).sum()) + int(ids.numel() > 0)


def compare_packed(bf16, shape, seed, timed=True, capacity=None):
    """One packed entry point against its plain version on one MF step's
    inputs, bit for bit, after "compact"'s cut to ``capacity`` unique ids
    when one is given (compact_rows, as the trainer applies it); its times
    when ``timed`` (a call by CUDA events, the device's time queued behind a
    sleep kernel, the plain version, one torch.optim.SparseAdam step over
    the same rows as the yardstick) and its bound. Returns a row."""
    name = "fused_rowadam_packed_bf16" if bf16 else "fused_rowadam_packed"
    kernel = fused_rowadam_packed_bf16 if bf16 else fused_rowadam_packed
    plain = fused_rowadam_packed_bf16_reference if bf16 else fused_rowadam_packed_reference
    layout, packed, ids, grads = packed_inputs(**shape, seed=seed, bf16=bf16)
    dropped = 0
    if capacity is not None:
        grads, dropped = compact_rows(ids, grads, capacity)
        dropped = int(dropped)
    denoms, lr = bias_denominators(3), 0.05
    want = plain(packed.clone(), layout.rects, ids, grads, denoms, lr)
    launches = kernel.launches
    got = kernel(packed.clone(), layout.rects, ids, grads, denoms, lr)
    torch.cuda.synchronize()
    touched = int(packed_touched(layout.rects, ids, grads).any(dim=1).sum())
    row = {"shape": [layout.total_rows, (4 if bf16 else 3) * layout.w], "dtype": "int16" if bf16 else "float32",
           "n_ids": int(ids.shape[0]), "ids": "zipf" if shape["zipf"] else "uniform", "touched_rows": touched,
           "max_abs_err": 0.0}
    if kernel.launches != launches + 1:
        fail(f"{name} launched {kernel.launches - launches} times for one call: {row}")
    if not torch.equal(got, want):
        wrong = int((got != want).any(dim=1).sum())
        if not bf16:
            row["max_abs_err"] = float((got - want).abs().max())
        fail(f"{name} disagrees with its plain version in {wrong} rows: {row}")
    if torch.equal(got, packed):
        fail(f"{name} wrote nothing: {row}")
    if capacity is not None:
        row.update(capacity=capacity, dropped=dropped)
    if not timed:
        cut = "," if capacity is None else f" after compact's capacity {capacity}: {dropped} unique ids dropped,"
        log("layouts", f"{name} {row['shape']}, L={row['n_ids']} {row['ids']} ids{cut} {first_occurrences(ids)} "
            f"first occurrences, {touched} touched rows, bit for bit the plain version")
    if timed:
        work = packed.clone()
        group = RowAdamPacked(work, layout.rects, bf16=bf16)

        def call():
            group(ids, grads, denoms, lr)

        row["ms"] = cuda_ms(call)
        row["device_ms"] = queued_ms(call)
        row["plain_ms"] = cuda_ms(lambda: plain(work, layout.rects, ids, grads, denoms, lr))
        param = torch.nn.Parameter(torch.randn(layout.total_rows, layout.w, device="cuda"))
        sparse_adam = torch.optim.SparseAdam([param], lr=lr)
        coo = torch.sparse_coo_tensor(ids[None], grads, param.shape)

        def library():
            param.grad = coo
            sparse_adam.step()

        row["library_ms"] = cuda_ms(library)
        row["bound_ms"], row["bound_by"] = packed_bound(touched, layout.w, row["n_ids"], bf16)
        row["first_rows"] = first_occurrences(ids)
        row["read_bound_ms"] = packed_read_bound(row["first_rows"], touched, layout.w, row["n_ids"], bf16)
        log("layouts", f"{name} {row['shape']} ({row['dtype']}), L={row['n_ids']} {row['ids']} ids, "
            f"{row['first_rows']} first occurrences, {touched} touched rows: bit for bit the plain version; a call "
            f"{row['ms'] * 1e3:.2f} us, on the device {row['device_ms'] * 1e3:.2f} us, plain "
            f"{row['plain_ms'] * 1e3:.2f} us, SparseAdam {row['library_ms'] * 1e3:.2f} us; bound "
            f"{row['bound_ms'] * 1e3:.3f} us by {row['bound_by']} (device share "
            f"{row['bound_ms'] / row['device_ms']:.3f}), of what a write that skips duplicates reads "
            f"{row['read_bound_ms'] * 1e3:.3f} us (share "
            f"{row['read_bound_ms'] / row['device_ms']:.3f})")
    return row


def train_layout(layout, seed, root_dir):
    """mf_default.json (sparse_optim true) under ``layout`` at
    MF_SPARSE_EPOCHS: one packed launch a step and nothing else, best valid
    and test ndcg@10 in the JAX band, examples/s beside phase 3's. Returns
    (the recommender, the kernels' counts of its train())."""
    phase = f"{layout}-train"
    zero_kernel_counts()
    rec, result, _, res = train_mf(phase, seed, root_dir, sparse_optim=True, row_update=layout,
                                   max_epoch=MF_SPARSE_EPOCHS)
    counts = kernel_counts()
    kernel = "fused_rowadam_packed_bf16" if layout == "unified_bf16" else "fused_rowadam_packed"
    steps = len(rec.engine.bookkeeper.history) * rec.engine.epoch_fn.num_batches
    check_launches(kernel, phase, counts[kernel], steps)
    if any(v for k, v in counts.items() if k != kernel):
        fail(f"{phase}: launched {counts}; the path runs {kernel} alone")
    band = layout_band(layout)
    rate, fused = median_rate(phase), median_rate("mf-sparse")
    log(phase, f"(cap {MF_SPARSE_EPOCHS} epochs) "
        + in_band("best valid ndcg@10", result["valid_metric"], band["valid"]) + "; "
        + in_band("test ndcg@10", res["ndcg@10"], band["test"])
        + f"; examples/s {rate:.1f} against {fused:.1f} under \"fused\" (phase 3, this call): {rate / fused:.3f}x")
    return rec, counts


def compact_drops(seed, root_dir, default_rec):
    """"compact" at COMPACT_STARVED drops rows, counts them and warns once an
    epoch; at its default capacity (``default_rec``'s training) it drops
    JAX_COMPACT_DROPPED. Returns the kernels' counts of the starved run."""
    phase = "compact-starved"
    trainer = default_rec.engine.epoch_fn
    dropped = int(trainer.dropped)
    if dropped != JAX_COMPACT_DROPPED:
        fail(f"compact-train: dropped {dropped} rows at the default capacity {trainer.compact_capacity}, the JAX "
             f"package {JAX_COMPACT_DROPPED}")
    log("compact-train", f"default capacity {trainer.compact_capacity} of {3 * trainer.batch_size} ids a step "
        f"(the JAX package's estimate): dropped {dropped} rows, as the JAX package's seed 0")
    rec, engine = built_engine(MatrixFactorization(mf_config(seed, root_dir, sparse_optim=True, row_update="compact",
                                                             max_epoch=1)), mf_split())
    engine.epoch_fn.compact_capacity = COMPACT_STARVED
    zero_kernel_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        engine.train(verbose=False)
    torch.cuda.synchronize()
    counts = kernel_counts()
    warned = out.getvalue().count("WARNING: sharded-sparse bucketed exchange dropped")
    dropped = int(engine.epoch_fn.dropped)
    if not dropped or warned != 1:
        fail(f"{phase}: capacity {COMPACT_STARVED}: dropped {dropped} rows, {warned} warnings in 1 epoch")
    check_launches("fused_rowadam_packed", phase, counts["fused_rowadam_packed"], engine.epoch_fn.num_batches)
    log(phase, f"capacity {COMPACT_STARVED}: 1 epoch dropped {dropped} gradient rows "
        f"({dropped / engine.epoch_fn.num_batches:.1f} a step), counted in state[\"dropped\"] and warned once")
    return counts


def packed_state_memory(seed):
    """The optimizer state's device bytes at PACKED_SCALE's tables under
    "unified" and "unified_bf16": the packed array (and the bfloat16 form's
    float32 bias tables and moments), the memory held while packed against
    before (torch.cuda.memory_allocated) and the peak of the packing
    (torch.cuda.max_memory_allocated). Returns {layout: bytes}."""
    n_users, n_items, d = PACKED_SCALE["n_users"], PACKED_SCALE["n_items"], PACKED_SCALE["emb_dim"]
    out = {}
    for layout in ("unified", "unified_bf16"):
        model = MF({"emb_dim": d, "loss": "bpr"}, n_users, n_items, device="cuda")
        model.init_weights(torch.Generator().manual_seed(seed))
        arrays = types.SimpleNamespace(users=np.arange(1), items=np.arange(1))
        trainer = SparseEpochTrainer(model, arrays, 1, None, 0.05, None, row_update=layout)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with trainer._packed_epoch():
            torch.cuda.synchronize()
            held, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
            state = trainer._packed.numel() * trainer._packed.element_size()
            if layout == "unified_bf16":
                state += sum(3 * p.numel() * 4 for p in trainer.tables.values() if p.dim() == 1)
        out[layout] = state
        log("layouts", f"{layout} at {n_users:,} x {d} users, {n_items:,} items: optimizer state (tables and "
            f"moments) {state / 2**20:.1f} MiB; device memory {before / 2**20:.1f} MiB before packing, "
            f"{held / 2**20:.1f} MiB while packed, peak of the packing {peak / 2**20:.1f} MiB")
        del model, trainer
        torch.cuda.empty_cache()
    log("layouts", f"unified_bf16's optimizer state over unified's: {out['unified_bf16'] / out['unified']:.4f}")
    return out


def row_layouts_phase(seed, root_dir):
    """Phase 40. Returns (the two packed entry points' rows by shape, the
    kernels' counts by path)."""
    t0 = time.perf_counter()
    rows = {}
    for bf16 in (False, True):
        name = "fused_rowadam_packed_bf16" if bf16 else "fused_rowadam_packed"
        rows[name] = {"mf_step": compare_packed(bf16, PACKED_MF_STEP, seed),
                      "table_scale": compare_packed(bf16, PACKED_SCALE, seed + 1)}
    counts, recs = {}, {}
    for layout in LAYOUTS:
        recs[layout], counts[f"{layout}-train"] = train_layout(layout, seed, root_dir)
    trainer = recs["compact"].engine.epoch_fn
    if trainer.batch_size != PACKED_MF_STEP["batch"]:
        fail(f"compact-train: batch {trainer.batch_size}, the packed comparisons' MF step {PACKED_MF_STEP['batch']}")
    for capacity in (trainer.compact_capacity, COMPACT_STARVED):
        compare_packed(False, PACKED_MF_STEP, seed, timed=False, capacity=capacity)
    compare_packed(False, PACKED_SCALE, seed + 1, timed=False, capacity=PACKED_SCALE_CAPACITY)
    for bf16 in (False, True):
        compare_packed(bf16, PACKED_SCALE_UNIFORM, seed + 1, timed=False)
    counts["compact-starved"] = compact_drops(seed, root_dir, recs["compact"])
    del recs
    packed_state_memory(seed)
    log("layouts", f"phase 40 took {time.perf_counter() - t0:.2f} s")
    return rows, counts


def packed_entry(name, rows, launches):
    """The kernels line's entry of one packed entry point: MF's step as its
    headline shape, the table-scale step beside it."""
    head = rows["mf_step"]
    return {
        "name": name,
        "route": "cuda",
        "source": "beta_recsys_tpu_torch/csrc/rowadam.cu",
        "replaces": "beta_recsys_tpu/ops/pallas/rowadam.py:53",
        "layout_code": "beta_recsys_tpu/core/sparse_optim.py:380",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms", "shape",
                                "dtype")},
        "timed": {key: {k: r[k] for k in ("shape", "n_ids", "ids", "first_rows", "touched_rows", "ms", "device_ms",
                                          "plain_ms", "bound_ms", "bound_by", "read_bound_ms", "library_ms")}
                  for key, r in rows.items()},
    }


PROFILE_GRAPH = "graph-models"  # phases 20-22's profiles
PROFILE_CAPPED = "capped-models"  # phases 23-25's profiles
PROFILE_SSL = "ssl-models"  # phases 26-27's profiles
PROFILE_SEQ = "seq-models"  # phases 28-30's profiles
PROFILE_GROCERY = "grocery-models"  # phases 31-33's profiles
# All five run in one child process after phase 33 (one process start, not five).
PROFILES = (PROFILE_GRAPH, PROFILE_CAPPED, PROFILE_SSL, PROFILE_SEQ, PROFILE_GROCERY)
PROFILED_CAPPED_STEPS = 3  # training steps profiled for each model of phases 21-22 and 24-30
PROFILE_WARMUP_STEPS = 2  # steps run before each profiled window


def profile_phase(phase, seed):
    """``--profile``: the profiled calls of phases 20-22, 23-25, 26-27,
    28-30 or 31-33 together, in this process alone. A profile without CUDA
    events prints a WARNING line."""

    def report(what, text):
        print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {what}: {text}", flush=True)
        if "not measured" in text:
            print(f"WARNING: {phase}: the profiler recorded no CUDA events for {what}", flush=True)

    data = mf_split()
    with tempfile.TemporaryDirectory() as root_dir:
        if phase == PROFILE_GRAPH:
            for name, (cls, _, _) in GRAPH_FAMILY.items():
                path = graph_checkpoint(name)
                rec = cls(load_config(path).replace(system={"root_dir": root_dir})).load(path, data)
                rec.test()
                rec.recommend(k=10)
                report(f"{name} test()", device_breakdown(rec.test))
                report(f"{name} recommend()", device_breakdown(lambda: rec.recommend(k=10)))
            for name, (cls, _, _) in GRAPH_FAMILY.items():
                rec = cls(graph_config(name, seed, root_dir))
                rec.data = data
                engine = TrainEngine(rec.config, rec.device).build(rec._build_model(data.n_users, data.n_items), data)
                trainer = engine.epoch_fn
                trainer.run_batches(*(x[:PROFILE_WARMUP_STEPS] for x in trainer.form(engine.generator)), generator=engine.generator)
                report(f"{name} {PROFILED_CAPPED_STEPS} steps", profile_window(trainer, engine.generator,
                                                                           PROFILED_CAPPED_STEPS, top=8))
            return
        if phase == PROFILE_CAPPED:
            path = os.path.join(REPO, "parity_runs/checkpoints", ULTRAGCN_CHECKPOINT)
            rec = UltraGCN(load_config(path).replace(system={"root_dir": root_dir})).load(path, data)
            rec.test()
            rec.recommend(k=10)
            report("UltraGCN test()", device_breakdown(rec.test))
            report("UltraGCN recommend()", device_breakdown(lambda: rec.recommend(k=10)))
            pretrained = None
            for name in CAPPED_FAMILY:
                rec = CAPPED_FAMILY[name][0](capped_config(name, seed, root_dir), **(pretrained or {}))
                rec.data = data
                rec.model = rec._build_model(data.n_users, data.n_items)
                rec.engine = TrainEngine(rec.config, rec.device).build(rec.model, data)
                trainer = rec.engine.epoch_fn
                trainer.run_batches(*(x[:PROFILE_WARMUP_STEPS] for x in trainer.form(rec.engine.generator)))  # to warm up
                report(f"{name} {PROFILED_CAPPED_STEPS} steps", profile_window(trainer, rec.engine.generator,
                                                                           PROFILED_CAPPED_STEPS, top=8))
                if name == "PairwiseGMF":
                    pretrained = {"user_embeddings": rec.model.user_memory.detach(),
                                  "item_embeddings": rec.model.item_memory.detach()}
                if name == "CMN":
                    report("CMN test()", device_breakdown(rec.test))
            return
        if phase == PROFILE_GROCERY:
            data = grocery_split()
            path = os.path.join(REPO, "parity_runs/checkpoints", TRIPLE2VEC_CHECKPOINT)
            rec = Triple2vec(load_config(path).replace(system={"root_dir": root_dir})).load(path, data)
            rec.test()
            rec.recommend(k=10)
            report("Triple2vec test()", device_breakdown(rec.test))
            report("Triple2vec recommend()", device_breakdown(lambda: rec.recommend(k=10)))
            for name, (cls, config) in KNN_FAMILY.items():
                rec = cls(shipped_config(config, seed, root_dir))
                rec.train(mf_split())
                rec.test()
                report(f"{name} test()", device_breakdown(rec.test))
        if phase in (PROFILE_SSL, PROFILE_SEQ, PROFILE_GROCERY):
            family, engine_of = {PROFILE_SSL: (SSL_FAMILY, ssl_engine), PROFILE_SEQ: (SEQ_FAMILY, seq_engine),
                                 PROFILE_GROCERY: (GROCERY_FAMILY, grocery_engine)}[phase]
            data = seq_split() if phase == PROFILE_SEQ else data
            steps = GROCERY_PROFILED_STEPS if phase == PROFILE_GROCERY else PROFILED_CAPPED_STEPS
            for name in family:
                _, engine = engine_of(name, seed, root_dir, data)
                trainer = engine.epoch_fn
                trainer.run_batches(*(x[:PROFILE_WARMUP_STEPS] for x in trainer.form(engine.generator)), generator=engine.generator)
                report(f"{name} {steps} steps", profile_window(trainer, engine.generator, steps, top=8))
            return


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sharded-only", action="store_true",
                        help="run only the ring kernel and the sharded MF phases (11-16)")
    parser.add_argument("--ring-only", action="store_true",
                        help="run only the ring kernel's checks and times (11-12)")
    parser.add_argument("--mesh-only", action="store_true",
                        help="build the four kernels and run only the dense mesh phase (37)")
    parser.add_argument("--layouts-only", action="store_true",
                        help="build the rowadam kernels and run only the row layouts phase (40) after phase 3")
    parser.add_argument("--profile", nargs="+", choices=PROFILES,
                        help="profile phases 20-22, 23-25, 26-27, 28-30 and/or 31-33 in this process alone (the "
                             "main run runs all five in one child)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    if args.profile:
        fp32_matmuls()
        for phase in args.profile:
            profile_phase(phase, args.seed)
        return 0

    smi = nvidia_smi_line()
    print(smi, flush=True)
    fp32_matmuls()
    log("env", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    mark("1 build")
    sharded_only = args.sharded_only or args.ring_only
    built = _build.build_all(["ring_allgather"] if sharded_only else ["rowadam"] if args.layouts_only
                             else ["flash_attention_fwd", "flash_attention_bwd", "rowadam", "ring_allgather"])
    wall = time.perf_counter() - t0
    for name, (lib, secs, report) in built.items():
        log("build", f"{name}: {os.path.relpath(lib, REPO)} in {secs:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log("build", "  " + line.strip())
    log("build", f"nvcc calls in parallel: {wall:.2f} s of wall time; one after another they "
        f"take {sum(secs for _, secs, _ in built.values()):.2f} s")

    if args.mesh_only:
        with tempfile.TemporaryDirectory() as root_dir:
            dense_mesh_phases(args.seed, root_dir)
        return 0
    if args.layouts_only:  # phase 3's rate is the layouts' yardstick
        with tempfile.TemporaryDirectory() as root_dir:
            mf_sparse_training(args.seed, root_dir)
            row_layouts_phase(args.seed, root_dir)
        log("time", "seconds: " + json.dumps({"total": round(time.perf_counter() - T0, 2)}))
        return 0
    if sharded_only:
        with tempfile.TemporaryDirectory() as root_dir:
            ring_rows, ring_launches = sharded_phases(args.seed, root_dir, cards_only=True, ring_only=args.ring_only)
        if args.ring_only:
            print(json.dumps({"kernels": [ring_entry(ring_rows, ring_launches)]}), flush=True)
        else:
            finish(smi, [ring_entry(ring_rows, ring_launches)])
        return 0

    mark("2 kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n in (2, 1886):
            for t in (1, 77, 100, 200):
                timed = (n, t) == (1886, 100)
                row = compare_flash(n, t, 32, dtype, gen, timed)
                rows[(n, t, dtype)] = row
                log("flash", json.dumps(row))
        # The default config's recommend() blocks: 4096 users x 2 heads, maxlen 200.
        row = compare_flash(8192, 200, 32, dtype, gen, timed=True)
        rows[(8192, 200, dtype)] = row
        log("flash", json.dumps(row))

    # Training: forward and backward at a batch of 128 sequences x 2 heads,
    # every head dim, both dropout rates, both types, the paths' lengths and
    # the backward's 64-row tile edges (63-65, 128, 129); then times at the
    # checkpoint config's shape (T 100) and the shipped config's (T 200),
    # and at dh 16 (emb 32, 2 heads) and dh 64 (1 head).
    train_rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (16, 32, 64):
            for t in (1, 63, 64, 65, 77, 100, 128, 129, 200):
                for rate in (0.0, DROPOUT_RATE):
                    train_rows.append(compare_flash_train(256, t, dh, dtype, rate, gen))
    for row in train_rows:
        log("flash-train", json.dumps(row))
    worst = {name: max(r["bwd_max_abs_err"] for r in train_rows if r["dtype"] == name) for name in ("float32", "bfloat16")}
    log("flash-train", f"{len(train_rows)} shapes: forward and backward within their limits, masks bit-equal; "
        f"largest backward |d| {worst}")
    timed_train = {
        (n, t, dh, rate): time_flash_train(n, t, dh, torch.float32, rate, gen)
        for n, t, dh, rate in ((256, 100, 32, DROPOUT_RATE), (256, 100, 32, 0.0), (256, 200, 32, DROPOUT_RATE),
                               (256, 200, 32, 0.0), (256, 100, 16, DROPOUT_RATE), (128, 100, 64, DROPOUT_RATE))
    }

    # The MF path's step in one launch (user_emb with L = B, item_emb with
    # L = 2B at B = 400), each of its tables alone, a table-scale shape, and
    # ragged or narrow widths.
    mf_step_row = compare_rowadam_group([(943, 400, 64), (1682, 800, 64)], args.seed, timed=True)
    log("rowadam", f"mf_step: {json.dumps(mf_step_row)}")
    rowadam_rows = {
        "user_emb": compare_rowadam(943, 400, 64, args.seed, timed=True),
        "item_emb": compare_rowadam(1682, 800, 64, args.seed + 1, timed=True),
        "table_scale": compare_rowadam(1_000_000, 16_384, 64, args.seed + 2, zipf=True, timed=True),
    }
    for i, d in enumerate((1, 65, 128)):
        rowadam_rows[f"d{d}"] = compare_rowadam(4096, 1024, d, args.seed + 3 + i)
    for key, row in rowadam_rows.items():
        log("rowadam", f"{key}: {json.dumps(row)}")

    mark("7 default's data")
    t0 = time.perf_counter()
    ml1m = SequentialData(ml1m_shaped_split(args.seed))
    log("default", f"synthetic split: {ml1m.n_users} users, {ml1m.n_items} items, "
        f"{len(ml1m.train[DEFAULT_USER_COL])} train rows ({time.perf_counter() - t0:.2f} s)")
    with tempfile.TemporaryDirectory() as root_dir:
        mark("3 mf-sparse")
        adam_launches = {"mf_sparse_train": mf_sparse_training(args.seed, root_dir)}
        bwd_launches = {}
        mark("4 mf-dense")
        mf_dense_training(args.seed, root_dir)
        mark("5 mf-serve")
        serve_mf_checkpoint(root_dir)
        mark("6 checkpoint")
        launches = {"checkpoint": serve_checkpoint(root_dir)}
        mark("7 default")
        launches["default"] = serve_default_config(args.seed, root_dir, ml1m)
        mark("8 sasrec-train")
        train_counts = sasrec_training(args.seed, root_dir)
        mark("9 shipped")
        train_counts["shipped_shape"] = sasrec_shipped_shape(args.seed, root_dir, ml1m)
        mark("10 head dims")
        train_counts.update(sasrec_head_dims(args.seed, root_dir))
        mark("11-16 ring and sharded MF")
        ring_rows, ring_launches = sharded_phases(args.seed, root_dir)
        mark("17-19 NCF family")
        ncf_phases(args.seed, root_dir)
        mark("20-22 graph")
        graph_counts = graph_phases(args.seed, root_dir)
        mark("23-25 multineg and CMN")
        graph_counts.update(capped_phases(args.seed, root_dir))
        mark("26-27 self-supervised")
        graph_counts.update(ssl_phases(args.seed, root_dir))
        mark("28-30 sequence and VAE")
        graph_counts.update(seq_phases(args.seed, root_dir))
        mark("31-33 grocery and KNN")
        graph_counts.update(grocery_phases(args.seed, root_dir))
        mark("34-36 serving and resume")
        graph_counts.update(serving_and_resume_phases(args.seed, root_dir))
        mark("37 dense mesh")
        graph_counts.update(dense_mesh_phases(args.seed, root_dir))
        mark("38 mixed precision, pipeline, run layer")
        train_counts["sasrec_bf16"], bf16_counts, bf16_train_row = mixed_precision_phases(args.seed, root_dir, gen)
        graph_counts.update(bf16_counts)
        mark("39 raw-file adapters")
        graph_counts.update(raw_adapters_phase(args.seed, root_dir))
        mark("40 row layouts")
        packed_rows, layout_counts = row_layouts_phase(args.seed, root_dir)
        graph_counts.update(layout_counts)
        mark("profiles of 20-33 (one child)")
        profiled_in_child(PROFILES, args.seed)
        mark()
    log("time", "seconds by phase: " + json.dumps(PHASE_SECONDS))
    # Phases 17-40: 0 but 34's flash, 36's, 38's and 39's fused_rowadam, 37's
    # and 40's packed entry points.
    packed_launches = {"fused_rowadam_packed": {}, "fused_rowadam_packed_bf16": {}}
    for path, counts in graph_counts.items():
        launches[path] = counts["flash_causal_attention_fwd"]
        bwd_launches[path] = counts["flash_causal_attention_bwd"]
        adam_launches[path] = counts["fused_rowadam"]
        ring_launches[path] = counts["ring_allgather"]
        for name, by_path in packed_launches.items():
            by_path[path] = counts[name]
    for path, counts in train_counts.items():
        launches[f"{path}/steps"] = counts["steps"]
        if "eval" in counts:
            launches[f"{path}/eval"] = counts["eval"]
    bwd_launches.update({path: counts["bwd"] for path, counts in train_counts.items()})

    main_row = rows[(1886, 100, torch.float32)]
    train_row = timed_train[(256, 100, 32, DROPOUT_RATE)]
    path_row = mf_step_row
    f32_train = [r for r in train_rows if r["dtype"] == "float32"]
    kernels = [{
        "name": "flash_causal_attention_fwd",
        "route": "cuda",
        "source": "beta_recsys_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "beta_recsys_tpu/ops/pallas/flash_attention.py:57",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max([r["max_abs_err"] for key, r in rows.items() if key[2] == torch.float32]
                           + [r["max_abs_err"] for r in f32_train]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "dtype": main_row["dtype"],
        "timed_training": [{"shape": r["shape"], "rate": r["rate"], "ms": r["fwd_ms"], "plain_ms": r["fwd_plain_ms"],
                            "bound_ms": r["fwd_bound_ms"], "bound_by": r["fwd_bound_by"],
                            "library_ms": r["fwd_library_ms"]} for r in timed_train.values()],
        "bfloat16": {
            "max_abs_err": max([r["max_abs_err"] for key, r in rows.items() if key[2] == torch.bfloat16]
                               + [r["max_abs_err"] for r in train_rows if r["dtype"] == "bfloat16"]),
            "serving": {k: rows[(1886, 100, torch.bfloat16)][k]
                        for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "training": {"shape": bf16_train_row["shape"], "rate": bf16_train_row["rate"],
                         "ms": bf16_train_row["fwd_ms"], "plain_ms": bf16_train_row["fwd_plain_ms"],
                         "bound_ms": bf16_train_row["fwd_bound_ms"], "bound_by": bf16_train_row["fwd_bound_by"],
                         "library_ms": bf16_train_row["fwd_library_ms"]},
        },
    }, {
        "name": "flash_causal_attention_bwd",
        "route": "cuda",
        "source": "beta_recsys_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "beta_recsys_tpu/ops/pallas/flash_attention.py:80",
        "launches": sum(bwd_launches.values()),
        "launches_by_path": bwd_launches,
        "max_abs_err": max(r["bwd_max_abs_err"] for r in f32_train),
        "ms": train_row["bwd_ms"],
        "device_ms": train_row["bwd_device_ms"],
        "plain_ms": train_row["bwd_plain_ms"],
        "bound_ms": train_row["bwd_bound_ms"],
        "bound_by": train_row["bwd_bound_by"],
        "library_ms": train_row["bwd_library_ms"],
        "shape": train_row["shape"],
        "dtype": train_row["dtype"],
        "rate": train_row["rate"],
        "timed": [{"shape": r["shape"], "rate": r["rate"], "ms": r["bwd_ms"], "device_ms": r["bwd_device_ms"],
                   "plain_ms": r["bwd_plain_ms"],
                   "bound_ms": r["bwd_bound_ms"], "bound_by": r["bwd_bound_by"],
                   "library_ms": r["bwd_library_ms"]} for r in timed_train.values()],
        "bfloat16": {
            "max_abs_err": max(r["bwd_max_abs_err"] for r in train_rows if r["dtype"] == "bfloat16"),
            "training": {"shape": bf16_train_row["shape"], "rate": bf16_train_row["rate"],
                         "ms": bf16_train_row["bwd_ms"], "device_ms": bf16_train_row["bwd_device_ms"],
                         "plain_ms": bf16_train_row["bwd_plain_ms"], "bound_ms": bf16_train_row["bwd_bound_ms"],
                         "bound_by": bf16_train_row["bwd_bound_by"],
                         "library_ms": bf16_train_row["bwd_library_ms"]},
        },
    }, {
        "name": "fused_rowadam",
        "route": "cuda",
        "source": "beta_recsys_tpu_torch/csrc/rowadam.cu",
        "replaces": "beta_recsys_tpu/ops/pallas/rowadam.py:53",
        "launches": sum(adam_launches.values()),
        "launches_by_path": adam_launches,
        "max_abs_err": max(r["max_abs_err"] for r in [*rowadam_rows.values(), path_row]),
        "ms": path_row["ms"],
        "plain_ms": path_row["plain_ms"],
        "bound_ms": path_row["bound_ms"],
        "bound_by": path_row["bound_by"],
        "library_ms": path_row["library_ms"],
        "device_ms": path_row["device_ms"],
        "queued_ms": path_row["queued_ms"],
        "shapes": path_row["shapes"],
        "dtype": "float32",
        "timed": {key: {k: rowadam_rows[key][k] for k in ("shape", "n_ids", "ids", "touched_rows", "ms", "device_ms",
                                                         "plain_ms", "bound_ms", "bound_by", "library_ms")}
                  for key in ("user_emb", "item_emb", "table_scale")},
    }, *(packed_entry(name, packed_rows[name], by_path) for name, by_path in packed_launches.items()),
        ring_entry(ring_rows, ring_launches)]
    finish(smi, kernels)
    return 0


def finish(smi, kernels):
    """The last three lines: the kernels, the card, and the result."""
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
