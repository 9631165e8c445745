"""The plain references against the port at tiny sizes on the CPU: the
same weights and inputs give the same losses, features, masks and
metrics."""

import json

import numpy as np
import pytest
import torch

from conftest import BENCH, SEED
from harness.spec import load_module

MF_CFG = json.loads((BENCH / "configs" / "mf-ml20m.json").read_text())["model"]
SASREC_CFG = {**json.loads((BENCH / "configs" / "sasrec-ml1m.json").read_text())["model"], "maxlen": 12,
              "emb_dim": 16}


def _ref(name):
    return load_module(BENCH / "reference" / f"{name}.py", f"test_reference_{name}")


def _port_model(cfg, n_users, n_items, weights, artifacts=None):
    from beta_recsys_tpu_torch.models import build_model

    model = build_model(cfg, n_users, n_items, artifacts=artifacts, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return model


def test_mf_loss_and_scores_are_the_ports():
    ref = _ref("mf")
    g = torch.Generator().manual_seed(SEED)
    w = ref.make_weights(MF_CFG, 30, 20, g, "cpu", item_prior=torch.randn(20, generator=g))
    model = _port_model(MF_CFG, 30, 20, w)
    users, pos, neg = (torch.randint(0, n, (64,), generator=g) for n in (30, 20, 20))
    rows = {"user_emb": w["user_emb"][users], "item_emb": w["item_emb"][torch.cat([pos, neg])],
            "user_bias": w["user_bias"][users], "item_bias": w["item_bias"][torch.cat([pos, neg])]}
    want = model.row_loss(rows, {"global_bias": w["global_bias"]}, {"users": users, "pos_items": pos, "neg_items": neg})
    got = ref.train_loss(MF_CFG, w, {"users": users, "pos": pos, "neg": neg})
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(ref.score_all(MF_CFG, w, torch.arange(30), {}), model.score_all(torch.arange(30)),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dropout", [False, True])
def test_sasrec_features_and_loss_are_the_ports(dropout):
    ref = _ref("sasrec")
    g = torch.Generator().manual_seed(SEED)
    w = ref.make_weights(SASREC_CFG, 8, 30, g, "cpu")
    seq = torch.randint(0, 31, (8, 12), generator=g)
    seq[:, :3] = 0  # left padding
    model = _port_model(SASREC_CFG, 8, 30, w)
    g_port, g_ref = (torch.Generator().manual_seed(7) if dropout else None for _ in range(2))
    torch.testing.assert_close(ref.features(SASREC_CFG, w, seq, g_ref), model.log2feats(seq, g_port),
                               rtol=1e-5, atol=1e-5)
    # The training layout: each position's target is the next input, the
    # last position's the newest item; padding has no target.
    newest = torch.randint(1, 31, (8, 1), generator=g)
    pos = torch.where(seq != 0, torch.cat([seq[:, 1:], newest], dim=1), 0)
    batch = {"seq": seq, "pos": pos, "neg": torch.where(pos != 0, torch.randint(1, 31, seq.shape, generator=g), 0)}
    g_port, g_ref = (torch.Generator().manual_seed(9) if dropout else None for _ in range(2))
    torch.testing.assert_close(ref.train_loss(SASREC_CFG, w, batch, g_ref), model.loss(batch, g_port),
                               rtol=1e-5, atol=1e-6)


def test_the_philox_mask_is_the_ports():
    from beta_recsys_tpu_torch.ops.kernels.philox import dropout_keep_mask

    from reference.philox import keep_mask

    seed = torch.tensor([2**61 + 12345])
    assert torch.equal(keep_mask(seed, 3, 17, 0.1), dropout_keep_mask(seed, 3, 17, 0.1))


def test_ranking_by_rank_is_the_ports_top_k_metrics():
    from beta_recsys_tpu_torch.ops.metrics import ranking_metrics

    from reference.ranking import held_out_ranks, metric_sums

    g = torch.Generator().manual_seed(SEED)
    scores = torch.randint(0, 12, (40, 50), generator=g).float()  # many ties
    masked = torch.rand(40, 50, generator=g) < 0.3
    items = torch.randint(0, 50, (40,), generator=g)
    masked[torch.arange(40), items] = False
    relevance = torch.zeros(40, 50)
    relevance[torch.arange(40), items] = 1.0
    want = ranking_metrics(scores.masked_fill(masked, -1e30), relevance, torch.ones_like(masked),
                           ("ndcg", "precision", "recall", "map"), (1, 5, 10))
    got = metric_sums(held_out_ranks(scores, masked, items), ("ndcg", "precision", "recall", "map"), (1, 5, 10))
    for key, value in want.items():
        assert got[key] / 40 == pytest.approx(float(value), abs=1e-6), key


def test_lazy_adam_and_adam_are_the_ports():
    from beta_recsys_tpu_torch.core.sparse_optim import sparse_adam_row_update

    from reference.adam import adam, lazy_adam

    g = torch.Generator().manual_seed(SEED)
    table = torch.randn(10, 4, generator=g)
    grad = torch.randn(10, 4, generator=g)
    grad[[2, 5]] = 0.0
    ours, m, v = table.clone(), torch.zeros(10, 4), torch.zeros(10, 4)
    theirs, m2, v2 = table.clone(), torch.zeros(10, 4), torch.zeros(10, 4)
    for step in (1, 2):
        lazy_adam(ours, grad, m, v, step, 0.05)
        sparse_adam_row_update(theirs, m2, v2, torch.arange(10), grad, 0.05, step)
    torch.testing.assert_close(ours, theirs, rtol=1e-6, atol=1e-7)
    p = torch.nn.Parameter(table.clone())
    opt = torch.optim.Adam([p], lr=0.5, betas=(0.9, 0.999), eps=1e-8)
    ours, m, v = table.clone(), torch.zeros(10, 4), torch.zeros(10, 4)
    for step in (1, 2, 3):
        p.grad = grad * step
        opt.step()
        adam(ours, grad * step, m, v, step, 0.5)
    torch.testing.assert_close(ours, p.detach(), rtol=1e-6, atol=1e-6)
