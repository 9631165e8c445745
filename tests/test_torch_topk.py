"""The port's ``ops/topk.py`` against the JAX package's on the same numpy
inputs: ``exclusion_lists`` exactly, ``retrieval_topk`` (exact and approx,
float32 and bfloat16, with and without exclusion, in user chunks) and
``streaming_topk`` (a block that does not divide the items, a mask, users
with fewer than k items left, tied scores) to float32 rounding of the dot
products, and ``topk_lowest_index``'s tie order against ``lax.top_k``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from beta_recsys_tpu.ops import topk as jax_topk
from beta_recsys_tpu_torch.ops import topk

N_USERS, N_ITEMS, D = 48, 3000, 66
# float32 dot products of 66 terms summed in another order: a few ulp.
VALUE_TOL = 1e-6


def _tables(seed=0, n_users=N_USERS, n_items=N_ITEMS, d=D):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.1, (n_users, d)).astype(np.float32),
            rng.normal(0, 0.1, (n_items, d)).astype(np.float32))


def _excl(seed, n_users=N_USERS, n_items=N_ITEMS, t=12):
    rng = np.random.default_rng(seed)
    ex = rng.integers(0, n_items, (n_users, t)).astype(np.int32)
    ex[np.arange(t)[None, :] >= rng.integers(1, t + 1, n_users)[:, None]] = -1  # ragged lists, -1 padded
    return ex


@pytest.mark.parametrize("n_rows", [None, 5])
def test_exclusion_lists_equal_jax(n_rows):
    rng = np.random.default_rng(1)
    dense = (rng.random((9, 40)) < 0.2).astype(np.float32) * rng.integers(0, 3, (9, 40))
    dense[3] = 0.0  # an empty row
    rows, cols = np.nonzero(rng.random((9, 40)) < 0.2)
    csr = sp.csr_matrix((dense[rows, cols], (rows, cols)), shape=(9, 40))  # stored zeros stay
    assert (csr.data == 0).any()
    got = topk.exclusion_lists(csr, n_rows=n_rows)
    want = jax_topk.exclusion_lists(csr, n_rows=n_rows)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_exclusion_lists_of_an_empty_matrix_equal_jax():
    csr = sp.csr_matrix((4, 7), dtype=np.float32)
    np.testing.assert_array_equal(topk.exclusion_lists(csr), jax_topk.exclusion_lists(csr))


@pytest.mark.parametrize("score_dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("with_exclusion", [False, True])
@pytest.mark.parametrize("user_chunk", [None, 16])
def test_retrieval_topk_exact_equals_jax(score_dtype, with_exclusion, user_chunk):
    u, items = _tables()
    ex = _excl(2) if with_exclusion else None
    want_v, want_i = jax_topk.retrieval_topk(
        jnp.asarray(u), jnp.asarray(items), 30, exclude_list=None if ex is None else jnp.asarray(ex),
        mode="exact", score_dtype=score_dtype, user_chunk=user_chunk)
    got_v, got_i = topk.retrieval_topk(torch.from_numpy(u), torch.from_numpy(items), 30, exclude_list=ex,
                                       mode="exact", score_dtype=score_dtype, user_chunk=user_chunk)
    assert got_v.dtype == torch.float32 and got_v.shape == (N_USERS, 30)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # bfloat16 scores: the same roundings of the same float32 sums
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=VALUE_TOL)
    if ex is not None:
        assert not (got_i.numpy()[:, :, None] == ex[:, None, :]).any()


@pytest.mark.parametrize("score_dtype", [None, "bfloat16"])
def test_retrieval_topk_approx_gives_jax_values_and_exact_ids(score_dtype):
    """The port's "approx" is the exact top k. On the CPU the JAX package's
    ``approx_max_k`` returns the same values; with float32 scores the same
    ids, with bfloat16 ones the same ids up to the order of tied values."""
    u, items = _tables(3)
    ex = _excl(4)
    want_v, want_i = jax_topk.retrieval_topk(jnp.asarray(u), jnp.asarray(items), 30, exclude_list=jnp.asarray(ex),
                                             mode="approx", score_dtype=score_dtype)
    got_v, got_i = topk.retrieval_topk(torch.from_numpy(u), torch.from_numpy(items), 30, exclude_list=ex,
                                       mode="approx", score_dtype=score_dtype)
    exact_v, exact_i = topk.retrieval_topk(torch.from_numpy(u), torch.from_numpy(items), 30, exclude_list=ex,
                                           mode="exact", score_dtype=score_dtype)
    assert torch.equal(got_i, exact_i) and torch.equal(got_v, exact_v)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=VALUE_TOL)
    want_i = np.asarray(want_i)
    if score_dtype is None:
        np.testing.assert_array_equal(got_i.numpy(), want_i)
    else:
        kth = got_v.numpy()[:, -1:]
        above = got_v.numpy() > kth  # ids of values no tie reaches
        for row in range(N_USERS):
            assert set(got_i.numpy()[row][above[row]]) == set(want_i[row][above[row]])


@pytest.mark.parametrize("recall_target", [0.0, 1.5])
def test_retrieval_topk_refuses_a_recall_target_outside_0_1(recall_target):
    """Every target in (0, 1] is met by the exact top k; another raises
    rather than be taken for a setting that acts."""
    u, items = _tables()
    with pytest.raises(ValueError, match="recall_target"):
        topk.retrieval_topk(torch.from_numpy(u), torch.from_numpy(items), 5, recall_target=recall_target)


def test_retrieval_topk_user_chunk_must_divide():
    u, items = _tables()
    with pytest.raises(ValueError, match="must divide"):
        topk.retrieval_topk(torch.from_numpy(u), torch.from_numpy(items), 5, user_chunk=7)


@pytest.mark.parametrize("block", [128, 1000, 4096])
@pytest.mark.parametrize("with_mask", [False, True])
def test_streaming_topk_equals_jax(block, with_mask):
    u, items = _tables(5, n_items=2500)
    mask = None
    if with_mask:
        rng = np.random.default_rng(6)
        mask = rng.random((N_USERS, 2500)) < 0.3
        mask[0] = True            # a user with nothing left
        mask[1, 5:] = True        # a user with fewer than k items left
    want_v, want_i = jax_topk.streaming_topk(jnp.asarray(u), jnp.asarray(items), 10, block=block,
                                             exclude_mask=None if mask is None else jnp.asarray(mask))
    got_v, got_i = topk.streaming_topk(torch.from_numpy(u), torch.from_numpy(items), 10, block=block,
                                       exclude_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=VALUE_TOL)
    if with_mask:
        assert (got_v.numpy()[0] == np.float32(topk.NEG_INF)).all() and (got_i.numpy()[0] == 0).all()
        assert (got_v.numpy()[1, 5:] == np.float32(topk.NEG_INF)).all()


def test_streaming_topk_ties_equal_jax():
    """Integer-valued tables: most scores tie, across blocks and within."""
    rng = np.random.default_rng(7)
    u = rng.integers(-1, 2, (20, 4)).astype(np.float32)
    items = rng.integers(-1, 2, (700, 4)).astype(np.float32)
    want_v, want_i = jax_topk.streaming_topk(jnp.asarray(u), jnp.asarray(items), 15, block=128)
    got_v, got_i = topk.streaming_topk(torch.from_numpy(u), torch.from_numpy(items), 15, block=128)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("k", [1, 7, 40, 300])
def test_topk_lowest_index_breaks_ties_as_lax_top_k(dtype, k):
    """Tied scores (few distinct values, -0.0 beside 0.0, the masked value)
    give ``lax.top_k``'s ids in ``lax.top_k``'s order, including ties at the
    k-th value that ``torch.topk`` alone would break another way."""
    rng = np.random.default_rng(8)
    x = rng.integers(-3, 4, (64, 300)).astype(np.float32) * 0.5
    x[0] = -0.0
    x[0, 7] = 0.0
    x[1, :] = topk.NEG_INF
    x[2, ::3] = topk.NEG_INF
    jx = jnp.asarray(x) if dtype == np.float32 else jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x) if dtype == np.float32 else torch.from_numpy(x).bfloat16()
    want_v, want_i = jax.lax.top_k(jx, k)
    got_v, got_i = topk.topk_lowest_index(tx, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.float().numpy(), np.asarray(want_v.astype(jnp.float32)))


def test_topk_lowest_index_on_random_rows_equals_a_stable_sort():
    x = torch.randn(32, 5000, generator=torch.Generator().manual_seed(0))
    x[:, 100] = x[:, 50]  # a tie somewhere in every row
    values, idx = topk.topk_lowest_index(x, 25)
    ref_v, ref_i = torch.sort(x, dim=1, descending=True, stable=True)
    assert torch.equal(idx, ref_i[:, :25]) and torch.equal(values, ref_v[:, :25])
