"""The attention dropout mask that the configuration states: Philox4x32-10.

A frozen copy of the arithmetic of the program's ``ops/kernels/philox.py``
(the plain version of its ``csrc/philox.cuh``). The mask is a pure function
of (seed, n, row, col): the 64-bit seed is the key (low and high 32 bits),
the counter is (col // 4, row, n, 0), and word col % 4 of the four output
words gives the bits of entry (n, row, col); an entry is kept when its bits
are >= min(floor(rate * 2^32), 2^32 - 1). Every 32-bit word is held in an
int64 tensor; a 32 x 32-bit product is formed from two products of at most
48 bits, so nothing overflows.
"""

import torch

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a, b):
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    s = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(counter, key):
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(seed, n, t, rate):
    """(n, t, t) bool keep mask at ``rate`` for ``seed``, a (1,) int64
    tensor."""
    s = seed.reshape(()).to(torch.int64)
    key = (s & _MASK32, (s >> 32) & _MASK32)
    dev = seed.device
    groups = -(-t // 4)
    words = philox4x32_10(
        (
            torch.arange(groups, device=dev)[None, None, :],
            torch.arange(t, device=dev)[None, :, None],
            torch.arange(n, device=dev)[:, None, None],
            torch.zeros((), dtype=torch.int64, device=dev),
        ),
        key,
    )
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(n, t, 4 * groups)[..., :t]
    return bits >= min(int(rate * float(2**32)), 2**32 - 1)
