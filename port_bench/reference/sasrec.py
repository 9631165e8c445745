"""Plain reference of SASRec (the ``sasrec-*`` configs; Kang & McAuley,
ICDM 2018, as the repository's models state it).

An item table with padding row 0 (n_items + 1 rows) scaled by sqrt(d),
learned position embeddings, ``num_blocks`` of [LN on the query -> causal
multi-head attention whose residual is the normalized query -> LN ->
pointwise FFN with its own residual] under the timeline mask, and a final
LN (eps 1e-8 inside the root, biased variance). Attention is the plain
softmax of q k^T / sqrt(dh) over the causal pairs, its probabilities
dropped by the Philox mask of ``reference/philox.py`` keyed on a seed drawn
from the step's generator. Dropout elsewhere keeps an entry where a uniform
draw is >= rate and scales it by 1 / (1 - rate). A step draws, in order:
the embedding dropout, then for each block the attention seed and the
FFN's two dropouts, as the configuration's model does.

Training: BCE-with-logits of every position's next item against one
negative, over the positions whose target is not padding, plus ``l2_emb``
times the Frobenius norm of the item table. Scoring: the final position's
features against every item.
"""

import math

import torch
import torch.nn.functional as F

from reference.philox import keep_mask
from reference.precision import dot, mm

NEG_INF = -1e30


def make_weights(model_cfg, n_users, n_items, gen, device, item_prior=None):
    """The weights both sides start from, in the program's parameter names:
    normal(0, stddev) item and position embeddings (item row 0 zero),
    Xavier-uniform projections, zero biases and unit LN scales, each kind
    in one draw on the device. With ``item_prior`` (an (n_items,) tensor)
    every item row gains prior[i] times a unit vector w, and the final LN's
    bias is w: each user's score of item i then holds prior[i], a
    popularity prior as a trained model holds."""
    d, std = int(model_cfg["emb_dim"]), float(model_cfg.get("stddev", 0.1))
    maxlen, blocks = int(model_cfg["maxlen"]), int(model_cfg["num_blocks"])
    emb = torch.randn(((n_items + 1) + maxlen) * d, generator=gen, device=device).mul_(std)
    w = {"item_emb": emb[: (n_items + 1) * d].view(n_items + 1, d).clone(),
         "pos_emb": emb[(n_items + 1) * d:].view(maxlen, d)}
    w["item_emb"][0] = 0.0
    bound = math.sqrt(6.0 / (d + d))  # Xavier-uniform of a (d, d) projection
    proj = torch.rand(blocks * 6 * d * d, generator=gen, device=device).mul_(2 * bound).sub_(bound)
    proj = proj.view(blocks, 6, d, d)
    for i in range(blocks):
        for j, name in enumerate(("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.w1", "ffn.w2")):
            w[f"blocks.{i}.{name}"] = proj[i, j]
        for ln in ("attn_ln", "ffn_ln"):
            w[f"blocks.{i}.{ln}.scale"] = torch.ones(d, device=device)
            w[f"blocks.{i}.{ln}.bias"] = torch.zeros(d, device=device)
        w[f"blocks.{i}.ffn.b1"] = torch.zeros(d, device=device)
        w[f"blocks.{i}.ffn.b2"] = torch.zeros(d, device=device)
    w["last_ln.scale"] = torch.ones(d, device=device)
    w["last_ln.bias"] = torch.zeros(d, device=device)
    if item_prior is not None:
        unit = torch.randn(d, generator=gen, device=device)
        unit = unit / unit.norm()
        w["item_emb"][1:] += item_prior.float()[:, None] * unit[None, :]
        w["last_ln.bias"] = unit.clone()
    return w


def lazy_tables(model_cfg):
    return ()


def _layer_norm(x, scale, bias):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-8) * scale + bias


def _dropout(gen, x, rate):
    if gen is None or rate <= 0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1 - rate), 0.0)


def _attention(p, i, q_in, x, heads, rate, gen, tf32):
    B, T, D = q_in.shape
    dh = D // heads
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=x.device) if gen is not None and rate > 0 else None

    def split(h):
        return h.reshape(B, T, heads, dh).transpose(1, 2).reshape(B * heads, T, dh)

    q = split(mm(q_in, p[f"blocks.{i}.attn.wq"], tf32))
    k = split(mm(x, p[f"blocks.{i}.attn.wk"], tf32))
    v = split(mm(x, p[f"blocks.{i}.attn.wv"], tf32))
    scores = mm(q, k.transpose(1, 2), tf32) * (1.0 / math.sqrt(dh))
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if seed is not None:
        probs = torch.where(keep_mask(seed, B * heads, T, rate), probs / (1.0 - rate), 0.0)
    out = mm(probs, v, tf32).reshape(B, heads, T, dh).transpose(1, 2).reshape(B, T, D)
    return mm(out, p[f"blocks.{i}.attn.wo"], tf32)


def features(model_cfg, p, seq, gen=None, tf32=False):
    """(B, T, d) features of (B, T) 1-indexed sequences; dropout when a
    generator is given."""
    d, heads = int(model_cfg["emb_dim"]), int(model_cfg["num_heads"])
    rate = float(model_cfg.get("dropout_rate", 0.1)) if gen is not None else 0.0
    T = seq.shape[1]
    x = p["item_emb"][seq] * torch.tensor(math.sqrt(d), dtype=torch.float32)
    x = x + p["pos_emb"][None, p["pos_emb"].shape[0] - T:, :]
    x = _dropout(gen, x, rate)
    timeline = (seq != 0)[..., None].float()
    x = x * timeline
    for i in range(int(model_cfg["num_blocks"])):
        q = _layer_norm(x, p[f"blocks.{i}.attn_ln.scale"], p[f"blocks.{i}.attn_ln.bias"])
        x = q + _attention(p, i, q, x, heads, rate, gen, tf32)
        x = _layer_norm(x, p[f"blocks.{i}.ffn_ln.scale"], p[f"blocks.{i}.ffn_ln.bias"])
        h = _dropout(gen, torch.relu(mm(x, p[f"blocks.{i}.ffn.w1"], tf32) + p[f"blocks.{i}.ffn.b1"]), rate)
        h = _dropout(gen, mm(h, p[f"blocks.{i}.ffn.w2"], tf32) + p[f"blocks.{i}.ffn.b2"], rate)
        x = (x + h) * timeline
    return _layer_norm(x, p["last_ln.scale"], p["last_ln.bias"])


def train_loss(model_cfg, p, batch, generator=None, tf32=False):
    seq, pos, neg = batch["seq"], batch["pos"], batch["neg"]
    feats = features(model_cfg, p, seq, generator, tf32)
    valid = pos != 0
    pos_logits = dot(feats, p["item_emb"][pos], tf32)
    neg_logits = dot(feats, p["item_emb"][neg], tf32)
    mask = valid.float()
    loss = ((F.softplus(-pos_logits) + F.softplus(neg_logits)) * mask).sum() / mask.sum().clamp(min=1.0)
    l2 = float(model_cfg.get("l2_emb", 0.0))
    if l2 > 0:
        loss = loss + l2 * p["item_emb"].square().sum().sqrt()
    return loss


def program_inputs(model_cfg, split, device):
    """The program's model is built with each user's scoring context."""
    from harness.data import context

    return {"ctx": context(split, int(model_cfg["maxlen"]))}


def score_all(model_cfg, p, users, inputs, tf32=False):
    final = features(model_cfg, p, inputs["ctx"][users])[:, -1, :]
    return mm(final, p["item_emb"][1:].T, tf32)


def forward_flops(model_cfg, n_seqs):
    """FLOPs of the encoder's forward over ``n_seqs`` full sequences:
    the four attention projections 4 * 2 * T * d^2, the FFN's two 2 * 2 *
    T * d^2, and q k^T and p v over the causal half of the pairs, 2 * 2 * d
    * T (T + 1) / 2, a block."""
    T, d, blocks = int(model_cfg["maxlen"]), int(model_cfg["emb_dim"]), int(model_cfg["num_blocks"])
    per_block = 8 * T * d * d + 4 * T * d * d + 2 * d * T * (T + 1)
    return n_seqs * blocks * per_block


def score_flops(model_cfg, n_users, n_items):
    """FLOPs of one scoring pass: the encoder over each user's context and
    the final position's product with every item."""
    return forward_flops(model_cfg, n_users) + 2 * n_users * n_items * int(model_cfg["emb_dim"])
