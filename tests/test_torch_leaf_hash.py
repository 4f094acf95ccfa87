"""The port's plain leaf hash (ministark_tpu_torch/ops/leaf_hash.py::
leaf_hash_plain) on groups built to sit at every SHA-256 padding boundary
(``BOUNDARY_CASES``: preimages of 55, 56, 63, 64, 119, 120 and 127 bytes and
their Fp4 counterparts), with components of 1 and of max_digits digits,
10^k - 1 and 10^k, p - 1, 2^64 - 1 on the 20-digit path and 2^32 - 1 on the
10-digit one: held against the JAX package's leaf hash
(``leaf_hash_device``) and hashlib over the Display strings. csrc/
leaf_hash.cu is held against the same groups in tests/test_torch_cuda.py and
chip_smoke.py. Digests must be identical (tolerance 0)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.ops.leaf_hash import leaf_hash_device
from ministark_tpu_torch.fields import BABYBEAR_FP, GOLDILOCKS_FP
from ministark_tpu_torch.ops import leaf_hash as lh
from ministark_tpu_torch.ops import sha256 as sh


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side: one intra-op
    thread each keeps the plain versions' torch ops from contending for the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _p(max_digits):
    return (GOLDILOCKS_FP if max_digits == 20 else BABYBEAR_FP).p


def _display(fmt, c, max_digits):
    """One element's Display string; on the 10-digit path the digits are
    the low word's."""
    v = [int(x) & 0xFFFFFFFF if max_digits == 10 else int(x) for x in c]
    if fmt == 0:
        return str(v[0])
    quad = [f"QuadExtField({v[i]} + {v[i + 1]} * u)" for i in range(0, len(v), 2)]
    if fmt == 1:
        return quad[0]
    return f"QuadExtField({quad[0]} + {quad[1]} * u)"


def _to_jax(v):
    """(n, c) u64 values -> the JAX leaf hash's (n, c, 2) [lo, hi] words."""
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    return jnp.asarray(np.stack([lo, hi], axis=-1))


@pytest.mark.parametrize("fmt,md,k,lengths", lh.BOUNDARY_CASES,
                         ids=[f"fmt{f}-md{m}-k{k}" for f, m, k, _ in lh.BOUNDARY_CASES])
def test_leaf_hash_plain_at_padding_boundaries(fmt, md, k, lengths):
    v = lh.boundary_groups(fmt, k, md, _p(md), lengths)
    got = lh.leaf_hash_plain(torch.from_numpy(v.view(np.int64)), k, fmt, md)
    out = sh.digests_to_bytes(got)
    for g, length in enumerate(lengths):
        pre = "".join(_display(fmt, c, md) for c in v[g * k:(g + 1) * k]).encode()
        assert len(pre) == length
        assert out[g].tobytes() == hashlib.sha256(pre).digest(), (g, length)
    want = np.asarray(leaf_hash_device(_to_jax(v), k, fmt, md, use_pallas=False))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_boundary_groups_hit_every_digit_extreme():
    """The groups carry 1- and max_digits-digit components, 10^k and
    10^k - 1, p - 1, 2^64 - 1 (20 digits) and 2^32 - 1 (10 digits)."""
    seen = {20: set(), 10: set()}
    for fmt, md, k, lengths in lh.BOUNDARY_CASES:
        seen[md].update(int(x) for x in lh.boundary_groups(fmt, k, md, _p(md),
                                                           lengths).reshape(-1))
    for md, top in ((20, (1 << 64) - 1), (10, (1 << 32) - 1)):
        vals = seen[md]
        assert {1, 9, top, _p(md) - 1} <= vals
        assert {1, md} <= {len(str(x)) for x in vals}
        assert any(x == 10 ** (len(str(x)) - 1) for x in vals if x > 9)
        assert any(x == 10 ** len(str(x)) - 1 for x in vals if x > 9)


def test_boundary_groups_refuse_unreachable_lengths():
    with pytest.raises(ValueError, match="no preimage of 127 bytes"):
        lh.boundary_groups(0, 6, 20, _p(20), (127,))
