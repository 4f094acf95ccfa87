"""The pipelined level kernel's route, replayed in torch ops
(``ntt_pipe.level_replay``), held to the plain level, to the plain radix-2
NTT through a whole factor walk and to ``pow`` for the kernel's tables, and
the kernel's lane maps held to the shared-memory banks: one body per check,
which tests/test_torch_ntt_backends.py (Goldilocks) and
tests/test_torch_bb_ntt.py (BabyBear) call with the field and its coset
offset. Exact: tolerance 0."""

import numpy as np
import torch

from ministark_tpu_torch.ops import ntt
from ministark_tpu_torch.ops.field import get_ops, pack_words
from ministark_tpu_torch.ops import ntt_pipe as pp

U64 = 1 << 64

# (log2 F, log2 R, log2 K_prod): every F the kernel takes, each tile
# width (C = 64 at F = 32 down to 16), K_prod > 1, and R under 16 (C = R)
LEVEL_SHAPES = [(5, 7, 0), (6, 6, 2), (7, 5, 3), (8, 5, 0), (9, 4, 1), (6, 2, 0)]


def _values(field, shape, seed):
    """Seeded canonical values with 0 and p - 1 up front, in the field's
    dtype (int64 Goldilocks, int32 BabyBear)."""
    v = np.random.default_rng(seed).integers(0, field.p, size=shape, dtype=np.uint64)
    v.reshape(-1)[:2] = [0, field.p - 1]
    return pack_words(v, get_ops(field).dtype)


def replay_matches_plain(log_f, log_r, log_k, shift, field):
    """``level_replay`` against ``level_plain`` on a (2, F, R) input: the
    coset with W's rows (level 0), W's two-table split with the scale, and
    the last level's scale alone; W is the twiddle table of the root of
    order F R / K_prod, its rows read at r // K_prod."""
    Fi, K = 1 << log_f, 1 << log_k
    x = _values(field, (2, Fi, 1 << log_r), log_f + 10 * log_r)
    tw = ntt.stage_table(field, field.get_root_of_unity(Fi), Fi, "cpu")
    log_e = log_f + log_r - log_k
    r = field.get_root_of_unity(1 << log_e)
    W = pp._twiddle_matrix(field, r, 1 << (log_r - log_k), Fi, "cpu")
    split = ntt.coset_tables(field, r, log_e, "cpu")
    scale = ntt.inv_n(field, 1 << (log_f + log_r))
    for pre, w, sc, s in ((shift, W, None, None), (None, W, scale, split),
                          (None, None, scale, None)):
        assert torch.equal(pp.level_replay(x, tw, pre, w, K, sc, field, s),
                           pp.level_plain(x, tw, pre, w, K, sc, field)), (pre, sc)


def transform_replay_matches_radix2(log_n, shift, field, monkeypatch):
    """``ntt_pipe.transform`` with every level replayed (``level_replay``)
    and W's split on (``SPLIT_W``: level 0 takes it, the others W's rows),
    against the plain radix-2 NTT: the coset on level 0, 1/n on the last
    level, the factor walk's K_prod."""
    split_levels = []

    def replay(x, tw, pre, W, k_prod, scale, field, w_split):
        if w_split is not None:
            split_levels.append(k_prod)
        return pp.level_replay(x, tw, pre, W, k_prod, scale, field, w_split)

    monkeypatch.setattr(pp, "level", replay)
    monkeypatch.setattr(pp, "SPLIT_W", {"gl": True, "bb": True})
    x = _values(field, (2, 1 << log_n), log_n)
    for inverse, pre in ((False, shift), (True, None)):
        assert torch.equal(pp.transform(x, inverse, pre, field=field),
                           ntt.transform_plain(x, inverse, pre, field=field))
    assert split_levels == [1, 1]     # level 0 of each transform


def kernel_tables_match_pow(log_n, shift, field):
    """The tables the kernel reads, at their boundary indices: each level's
    stage roots (the last row of its stage table), its W and W's split
    tables (lo[e mod 2^h] * hi[e >> h] = r^e), and level 0's coset tables
    over F R."""
    n, P = 1 << log_n, field.p
    for inverse in (False, True):
        levels = pp._tables(n, inverse, "cpu", field)
        splits = pp.w_split_tables(n, inverse, "cpu", field)
        assert len(splits) == len(levels) and splits[-1] is None
        r, rem = ntt._roots(field, n, inverse), n
        for (Fi, tw, W, _), split in zip(levels, splits):
            w = pow(r, rem // Fi, P)                   # the level's root
            for j in (0, 1, Fi // 2 - 1):
                assert int(tw[-1, j]) % U64 == pow(w, j, P)
            if W is not None:
                M = W.shape[0]
                assert int(W[M - 1, Fi - 1]) % U64 == pow(r, (M - 1) * (Fi - 1), P)
                lo, hi = split
                log_e = rem.bit_length() - 1
                h = ntt.coset_split(log_e)
                assert lo.shape == (1 << h,) and hi.shape == (1 << (log_e - h),)
                for e in (0, 1, (1 << h) - 1, 1 << h, (1 << h) + 1, (M - 1) * (Fi - 1)):
                    got = int(lo[e & ((1 << h) - 1)]) % U64 * (int(hi[e >> h]) % U64)
                    assert got % P == pow(r, e, P), e
            r, rem = pow(r, Fi, P), rem // Fi
    lo, hi = ntt.coset_tables(field, shift, log_n, "cpu")
    h = ntt.coset_split(log_n)
    for i in (0, 1, (1 << h) - 1, 1 << h, (1 << h) + 1, n - 1):
        got = int(lo[i & ((1 << h) - 1)]) % U64 * (int(hi[i >> h]) % U64)
        assert got % P == pow(shift, i, P), i


def _distinct(addrs, group, banks):
    """Each run of ``group`` accesses meets ``group`` different banks."""
    a = addrs.reshape(-1, group) % banks
    return all(len(set(row.tolist())) == group for row in a)


def lane_maps_meet_no_bank_conflict(log_f, log_r):
    """csrc/ntt_pipe.cu's lane maps on the swizzled tile, in the order the
    threads take them (consecutive lanes on consecutive units, groups and
    elements): each quarter-warp of the load (8 copies of 16 bytes) meets
    8 different 16-byte bank groups, and each half-warp of a stage round
    and of the store (16 words of 8 bytes) 16 different bank pairs; every
    copy is 16-byte aligned at both ends and a quarter-warp reads one
    128-byte run of x; the load and the store each cover the tile once."""
    log_c = pp.tile_log_c(log_f, log_r)
    assert log_c >= 4
    T, C = 1 << log_f, 1 << log_c
    word, q, c = pp.load_units(log_f, log_c)
    src = (ntt.bitrev(T, "cpu")[q] << log_r) + c
    assert bool((word % 2 == 0).all()) and bool((src % 2 == 0).all())
    assert _distinct(word // 2, 8, 8)
    runs = (src // 16).reshape(-1, 8)
    assert bool((runs == runs[:, :1]).all()) and _distinct(src // 2, 8, 8)
    assert sorted((word[:, None] + torch.arange(2)).reshape(-1).tolist()) == list(
        range(T * C))
    t0 = 0
    while t0 < log_f:     # stages<F, R>: group g holds base + k 2^t0 of column g % C
        R = min(3, log_f - t0)
        g = torch.arange((T * C) >> R)
        rest = g >> log_c
        base = (rest & ((1 << t0) - 1)) | ((rest >> t0) << (t0 + R))
        for k in range(1 << R):
            assert _distinct(pp.tile_addr(base + (k << t0), g & (C - 1), log_c), 16, 16)
        t0 += R
    k, cs = pp.store_lanes(log_f, log_c)
    words = pp.tile_addr(k, cs, log_c)
    assert _distinct(words, 16, 16)
    assert sorted(words.tolist()) == list(range(T * C))
    assert sorted((cs * T + k).tolist()) == list(range(T * C))
