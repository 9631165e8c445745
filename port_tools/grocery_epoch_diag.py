#!/usr/bin/env python3
"""One epoch of Triple2vec, VBCAR or TVBR at its shipped config, through the
JAX package and through the port on the CPU, on the same draws.

    JAX_PLATFORMS=cpu python port_tools/grocery_epoch_diag.py [VBCAR] [seed]

On the structured split with its synthetic baskets (``chip_smoke.grocery_split``),
the JAX ``make_triple_epoch_fn`` trains one epoch (196 steps of 512 triples
at ``configs/<model>_default.json``) from its initial params and key; the
port's ``TripleEpochTrainer`` trains the same epoch from the same params on
the order, the alias-table negatives and each step's latent noise that the
JAX epoch draws (one thread). Prints the two mean losses, the largest
parameter difference and each side's valid and test ndcg@10 after the
epoch: the shipped width's drift of one epoch, where the tests hold a
narrow one to 1e-5.
"""

import json
import os
import sys
import tempfile

import numpy as np
from jax_mf_band import REPO


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "VBCAR"
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    import chip_smoke
    from beta_recsys_tpu.core.eval_engine import RankingEvaluator as JaxRankingEvaluator
    from beta_recsys_tpu.core.train_engine import _padded_order, make_triple_epoch_fn
    from beta_recsys_tpu.models import build_model as jax_build_model
    from beta_recsys_tpu.ops.sampling import alias_negatives
    from beta_recsys_tpu.utils.alias_table import AliasTable
    from beta_recsys_tpu_torch.convert import flatten_params
    from beta_recsys_tpu_torch.core.eval_engine import RankingEvaluator
    from beta_recsys_tpu_torch.core.train_engine import TripleEpochTrainer, make_optimizer
    from beta_recsys_tpu_torch.models import build_model
    from beta_recsys_tpu_torch.models import vbcar as port_vbcar
    from beta_recsys_tpu_torch.utils.constants import DEFAULT_ITEM_COL

    data = chip_smoke.grocery_split()
    with tempfile.TemporaryDirectory() as root:
        cfg = chip_smoke.grocery_config(name, seed, root).model.to_dict()
    rec_cls = chip_smoke.GROCERY_FAMILY[name][0]
    rec = rec_cls(chip_smoke.grocery_config(name, seed, "unused"), device="cpu")
    art = rec.build_artifacts(data)
    ref = jax_build_model(cfg, data.n_users, data.n_items, art)
    params = ref.init_params(jax.random.key(seed))
    triples = data.sample_triples(int(cfg["n_sample"]), time_step=int(cfg.get("time_step", 0)), seed=seed)
    batch, n_neg, lr = int(cfg["batch_size"]), int(cfg["n_neg"]), float(cfg["lr"])
    n = len(triples["users"])
    num_batches = -(-n // batch)
    table = AliasTable(list(np.bincount(data.train[DEFAULT_ITEM_COL], minlength=data.n_items).astype(np.float64)))
    item_alias = (jnp.asarray(table.prob_arr, jnp.float32), jnp.asarray(table.alias_arr, jnp.int32))
    opt = optax.adam(lr)
    rng = jax.random.key(seed + 100)
    epoch = make_triple_epoch_fn(ref, opt, triples, batch, data.n_users, data.n_items, n_neg, donate=False,
                                 item_alias=item_alias)
    want_params, _, _, want_loss = epoch(params, opt.init(params), rng)

    _, perm_key, k1, k2, k3, k_epoch = jax.random.split(rng, 6)
    order = _padded_order(jax.random.permutation(perm_key, n), num_batches * batch).reshape(num_batches, batch)
    shape = (num_batches, batch, n_neg)
    draws = [order, jax.random.randint(k1, shape, 0, data.n_users, dtype=jnp.int32),
             *(alias_negatives(k, shape, *item_alias) for k in (k2, k3))]
    d = int(cfg["emb_dim"])
    noise = []
    for k in jax.random.split(k_epoch, num_batches):
        keys = jax.random.split(k, 6)
        noise += [torch.from_numpy(np.array(jax.random.normal(keys[i], (batch, d) if i < 3 else (batch, n_neg, d))))
                  for i in range(6)]
    port_vbcar.latent_noise = lambda generator, shape, device: noise.pop(0)
    ours = build_model(cfg, data.n_users, data.n_items, art, device="cpu")
    ours.load_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    optimizer = make_optimizer(cfg, ours.parameters())
    trainer = TripleEpochTrainer(ours, optimizer, triples, batch, data.n_users, data.n_items, n_neg)
    loss = float(trainer.run_batches(*(np.array(x) for x in draws), generator=torch.Generator()))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, want_params))
    gap = max(float((p.detach() - want[key]).abs().max()) for key, p in ours.named_parameters())

    out = {"model": name, "seed": seed, "loss": loss, "jax_loss": float(want_loss), "max_abs_param_diff": gap}
    for split, frames in (("valid", data.valid), ("test", data.test)):
        cand = data.eval_candidates(frames[0])
        with torch.no_grad():
            out[f"{split}_ndcg@10"] = RankingEvaluator(ours, cand, ("ndcg",), (10,)).evaluate()["ndcg@10"]
        out[f"jax_{split}_ndcg@10"] = float(JaxRankingEvaluator(ref, cand, ("ndcg",), (10,)).evaluate(
            want_params)["ndcg@10"])
    print(json.dumps(out))


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
