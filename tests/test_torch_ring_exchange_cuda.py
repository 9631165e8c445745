"""On a card: the ring all-gather CUDA kernels against their plain version,
bit for bit (they copy), with every rank on one card (loopback: the copy
kernel) and across cards where there are several (the one-shot kernel);
many calls back to back; the inputs they refuse; a pair of cards without
peer access; a launch on a card other than 0; and the sharded trainer on a
(1, 4) mesh of one card against the one-device trainer. Imports nothing of
JAX, so it runs on the card's machine:

    python3 -m pytest --noconftest tests/test_torch_ring_exchange_cuda.py -q

Every test skips without a CUDA device (the cross-card ones without two).
"""

import types

import numpy as np
import pytest
import torch

from beta_recsys_tpu_torch.core.sparse_optim import ShardedSparseEpochTrainer, SparseEpochTrainer
from beta_recsys_tpu_torch.models.mf import MF
from beta_recsys_tpu_torch.ops.kernels import ring_exchange
from beta_recsys_tpu_torch.ops.kernels.ring_exchange import ring_allgather, ring_allgather_reference
from beta_recsys_tpu_torch.parallel.mesh import make_mesh


def _cuda(n_devices=1):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if torch.cuda.device_count() < n_devices:
        pytest.skip(f"needs {n_devices} CUDA devices")


def _blocks(devices, c, d, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(c, d, generator=gen).to(dtype).to(dev) for dev in devices]


def _check_equal(blocks):
    before = ring_allgather.launches, ring_allgather.calls
    got = ring_allgather(blocks)
    want = ring_allgather_reference(blocks)
    for dev in {b.device for b in blocks}:
        torch.cuda.synchronize(dev)
    assert ring_allgather.calls == before[1] + 1
    assert ring_allgather.launches == before[0] + len({b.device for b in blocks})
    for g, w, b in zip(got, want, blocks):
        assert g.device == b.device and g.shape == (len(blocks), *b.shape)
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("c", [8, 200, 400, 8192])
def test_loopback_equals_plain_version(n, c):
    _cuda()
    _check_equal(_blocks(["cuda:0"] * n, c, 64, seed=n * c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [8, 200, 201, 8192])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_loopback_copy_at_every_rank_count(n, c, dtype):
    """The copy kernel: one launch, n stores of every vector it reads, the
    last CTA ragged (C 201 leaves a partial one), views of one tensor."""
    _cuda()
    blocks = _blocks(["cuda:0"] * n, c, 64, dtype, seed=n * 10_000 + c)
    _check_equal(blocks)
    outs = ring_allgather(blocks)
    assert all(o._base is outs[0]._base for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 4])
def test_across_cards_one_shot_every_pair(n):
    """The one-shot kernel on n cards in both orders, so every ordered pair
    of cards exchanges flags and stores."""
    _cuda(n)
    devices = [f"cuda:{i}" for i in range(n)]
    for order in (devices, devices[::-1]):
        for c in (8, 200, 8192):
            _check_equal(_blocks(order, c, 64, seed=n * 100 + c))
    _check_equal(_blocks(devices, 200, 64, torch.bfloat16))


@pytest.mark.cuda
def test_a_pair_without_peer_access_raises(monkeypatch):
    """A pair of cards with no peer path raises before any launch: the
    kernel has no host-staged fallback."""
    _cuda(2)
    lib = ring_exchange._library()
    monkeypatch.setattr(ring_exchange, "_RINGS", {})
    monkeypatch.setattr(lib, "ring_enable_peer", lambda dev, peer: 217 if (dev, peer) == (1, 0) else 0)
    launches = ring_allgather.launches
    with pytest.raises(RuntimeError, match="no peer access from cuda:1 to cuda:0"):
        ring_allgather(_blocks(["cuda:0", "cuda:1"], 8, 64))
    assert ring_allgather.launches == launches


@pytest.mark.cuda
def test_loopback_bfloat16():
    _cuda()
    _check_equal(_blocks(["cuda:0"] * 4, 200, 64, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [200, 8192])
def test_across_cards_equals_plain_version(c):
    _cuda(2)
    devices = [f"cuda:{i}" for i in range(min(torch.cuda.device_count(), 8))]
    _check_equal(_blocks(devices, c, 64, seed=c))
    _check_equal(_blocks([d for d in devices for _ in range(2)], c, 64, seed=c + 1))  # two ranks a card


@pytest.mark.cuda
def test_a_thousand_calls_back_to_back():
    """The flags are never reset: each call's epoch must see only its own
    stores, whatever the calls before it left."""
    _cuda()
    devices = ["cuda:0"] * 4
    if torch.cuda.device_count() >= 4:
        devices = [f"cuda:{i}" for i in range(4)]
    base = _blocks(devices, 200, 64)
    kept = []
    for k in range(1000):
        outs = ring_allgather([b + k for b in base])
        if k % 97 == 0 or k == 999:
            kept.append((k, outs))
    for dev in set(devices):
        torch.cuda.synchronize(dev)
    for k, outs in kept:
        for out in outs:
            assert torch.equal(out, torch.stack([(b + k).to(out.device) for b in base]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["row_width", "dtype", "shape", "stride", "mixed_devices"])
def test_refused_inputs_raise(case):
    _cuda()
    blocks = _blocks(["cuda:0"] * 4, 8, 16)
    if case == "row_width":
        blocks = _blocks(["cuda:0"] * 4, 8, 3)
    elif case == "dtype":
        blocks[1] = blocks[1].double()
    elif case == "shape":
        blocks[2] = blocks[2][:4]
    elif case == "stride":
        blocks[3] = torch.zeros(16, 8, device="cuda:0").t()
    else:
        blocks[0] = blocks[0].cpu()
    launches = ring_allgather.launches
    with pytest.raises(ValueError):
        ring_allgather(blocks)
    assert ring_allgather.launches == launches


@pytest.mark.cuda
def test_launch_on_a_second_card():
    """The library's own runtime starts on device 0: a launch on cuda:1 sets
    that device first and restores PyTorch's afterwards."""
    _cuda(2)
    torch.cuda.set_device(0)
    _check_equal(_blocks(["cuda:1"] * 4, 200, 64))
    assert torch.cuda.current_device() == 0
    assert torch.equal(torch.ones(3, device="cuda:0").sum(), torch.tensor(3.0, device="cuda:0"))


@pytest.mark.cuda
def test_backward_on_the_card():
    _cuda()
    blocks = [b.requires_grad_() for b in _blocks(["cuda:0"] * 4, 8, 16)]
    weights = [torch.randn(4, 8, 16, device="cuda:0") for _ in range(4)]
    sum((o * w).sum() for o, w in zip(ring_allgather(blocks), weights)).backward()
    for r, b in enumerate(blocks):
        assert torch.allclose(b.grad, sum(w[r] for w in weights))


@pytest.mark.cuda
def test_sharded_trainer_on_one_card_equals_the_one_device_trainer():
    """A (1, 4) mesh of cuda:0 through the ring and the bucketed exchange:
    every lookup copies rows and every sum meets zeros only, so one epoch
    gives the one-device lazy-Adam trainer's tables bit for bit; the ring
    runs once per row table a step."""
    _cuda()
    rng = np.random.default_rng(0)
    arrays = types.SimpleNamespace(users=rng.integers(0, 50, 600), items=rng.integers(0, 70, 600))
    cfg = {"emb_dim": 16, "loss": "bpr", "reg": 0.001}

    def model():
        m = MF(cfg, 50, 70, device="cuda:0")
        return m.init_weights(torch.Generator().manual_seed(0))

    def adam(params):
        return torch.optim.Adam(params, lr=0.05)

    neg = lambda gen, users, shape: torch.randint(0, 70, shape, generator=gen, device=users.device)  # noqa: E731
    ref_model = model()
    ref = SparseEpochTrainer(ref_model, arrays, 64, neg, 0.05, adam([ref_model.global_bias]), row_update="xla")
    batches = ref.form(torch.Generator(device="cuda:0").manual_seed(1))
    want = ref.run_batches(*batches)
    sharded_model = model()
    trainer = ShardedSparseEpochTrainer(sharded_model, arrays, 64, neg, 0.05, make_mesh(1, 4, ["cuda:0"] * 4), adam,
                                        lookup_strategy="ring", grad_exchange="bucketed")
    calls = ring_allgather.calls
    got = trainer.run_batches(*batches)
    trainer.assemble()
    torch.cuda.synchronize()
    assert ring_allgather.calls - calls == 2 * trainer.num_batches
    assert torch.equal(got, want) and int(trainer.dropped) == 0
    for (name, p), q in zip(ref_model.named_parameters(), sharded_model.parameters()):
        assert torch.equal(p, q), name
