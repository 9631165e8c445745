"""Plain reference of biased matrix factorization (the ``mf-*`` configs).

score(u, i) = sigmoid(u . i + b_u + b_i + b_g). Training: BPR,
-mean(log sigmoid(pos - neg)), plus ``reg`` times the squared entries of the
batch's rows (the user rows once, the item rows of positives and negatives)
over the batch size; gradients by autograd over whole tables, so a row's
gradient is the sum over its occurrences. Evaluation: full-catalog scores
in blocks of users.
"""

import torch

from reference.precision import dot, mm

TABLES = ("user_emb", "item_emb", "user_bias", "item_bias")


def make_weights(model_cfg, n_users, n_items, gen, device, item_prior=None):
    """The weights both sides start from, in the program's parameter names:
    embeddings normal(0, stddev) in one draw on the device, biases 0; with
    ``item_prior`` (an (n_items,) tensor) the item biases are set to it, a
    popularity prior as a trained biased MF holds."""
    d, std = int(model_cfg["emb_dim"]), float(model_cfg.get("stddev", 0.1))
    emb = torch.randn((n_users + n_items) * d, generator=gen, device=device).mul_(std)
    w = {
        "user_emb": emb[: n_users * d].view(n_users, d),
        "item_emb": emb[n_users * d:].view(n_items, d),
        "user_bias": torch.zeros(n_users, device=device),
        "item_bias": torch.zeros(n_items, device=device),
        "global_bias": torch.zeros((), device=device),
    }
    if item_prior is not None:
        w["item_bias"] = item_prior.float().clone()
    return w


def lazy_tables(model_cfg):
    """The tables lazy Adam updates; the rest take Adam."""
    return TABLES


def train_loss(model_cfg, p, batch, generator=None, tf32=False):
    users, pos, neg = batch["users"], batch["pos"], batch["neg"]
    reg = float(model_cfg.get("reg", 0.0))
    u, ub, g = p["user_emb"][users], p["user_bias"][users], p["global_bias"]
    ip, ineg = p["item_emb"][pos], p["item_emb"][neg]
    bp, bn = p["item_bias"][pos], p["item_bias"][neg]
    pos_s = torch.sigmoid(dot(u, ip, tf32) + ub + bp + g)
    neg_s = torch.sigmoid(dot(u, ineg, tf32) + ub + bn + g)
    loss = -torch.nn.functional.logsigmoid(pos_s - neg_s).mean()
    if reg:
        l2 = (u.square().sum() + ip.square().sum() + ineg.square().sum() + ub.square().sum()
              + bp.square().sum() + bn.square().sum())
        loss = loss + reg * l2 / users.shape[0]
    return loss


def program_inputs(model_cfg, split, device):
    """What the program's model is built with besides its sizes: nothing."""
    return {}


def score_all(model_cfg, p, users, inputs, tf32=False):
    """(U, n_items) scores of ``users`` against every item."""
    logits = mm(p["user_emb"][users], p["item_emb"].T, tf32)
    return torch.sigmoid(logits + p["user_bias"][users][:, None] + p["item_bias"][None, :] + p["global_bias"])


def score_flops(model_cfg, n_users, n_items):
    """FLOPs one scoring pass over ``n_users`` needs: the product with every
    item."""
    return 2 * n_users * n_items * int(model_cfg["emb_dim"])
