"""The wgmma digit kernels' layouts and routes (csrc/ntt_digit.cu), held on
the CPU: the K-major kernel table entry for entry against the JAX package's
digit matrix, the kernels' routes replayed in torch ops
(``ntt_digit.level_replay`` / ``digit_dot_replay``) against the plain
versions and the Pallas fused level in interpret mode, and the lane maps
against the shared-memory banks and the 16-byte store alignment. One body
per check; tests/test_torch_ntt_digit.py calls them. Exact: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import torch

from ministark_tpu.ops import gl as jgl
from ministark_tpu.ops import ntt_mxu as M
from ministark_tpu_torch.convert import i64_to_planes, planes_to_i64
from ministark_tpu_torch.fields import GOLDILOCKS_FP
from ministark_tpu_torch.ops import ntt_digit as nd

P = GOLDILOCKS_FP.p

# (F, R, twiddle): every F of the phase-3 shapes with and without the
# twiddle, a ragged R at each block size (BM 128, 64, 32) and R = 1
LEVEL_CASES = [(32, 24, False), (32, 24, True), (64, 24, False), (64, 24, True),
               (128, 24, False), (128, 130, True), (256, 3, True), (512, 1, False)]
# (B, K, R, N): R ragged and aligned to 16 (the TMA path), K = 64 (half a
# k-block), N = 384 (half an n-tile), R = 1
DOT_CASES = [(2, 256, 33, 1024), (1, 64, 1, 128), (1, 512, 160, 384),
             (2, 128, 32, 256)]


def _values(shape, seed):
    v = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    edges = [0, 1, nd.GL_CENTER_T, nd.GL_CENTER_T + 1, P - 1]
    v.reshape(-1)[:len(edges)] = edges[:v.size]
    return torch.from_numpy(v.view(np.int64))


def kernel_table_matches_jax(F):
    """Row ``table_row(k, j)``, byte 8 m + a of the cached table holds digit
    j of centre(w^(m k) 256^a): the JAX matrix's entry (a F + m, j F + k)."""
    root = GOLDILOCKS_FP.get_root_of_unity(F)
    want = M._dft_digit_matrix(P, root, F)              # (8F, 8F): (a F + m, j F + k)
    assert np.array_equal(nd._dft_digit_matrix(P, root, F), want)
    vd = nd.digit_matrix(root, F, "cpu")                # padded to PF 128 at F 32
    table = nd._level_table(vd, F)
    assert table is nd._level_table(vd, F)              # made once, then cached
    assert table.shape == (8 * F, 8 * F) and table.is_contiguous()
    k, j = np.meshgrid(np.arange(F), np.arange(8), indexing="ij")
    rows = nd.table_row(k, j)
    assert sorted(rows.reshape(-1).tolist()) == list(range(8 * F))
    # want[a F + m, j F + k] -> (k, j, m, a)
    expect = want.reshape(8, F, 8, F).transpose(3, 2, 1, 0).reshape(F, 8, 8 * F)
    got = table.numpy()[rows]
    assert np.array_equal(got, expect)
    # a matrix not from the cache gets its table made in the call
    other = vd.clone()
    assert nd._level_table(other, F) is not table
    assert torch.equal(nd._level_table(other, F), table)


def _jax_level(x, root, F, W, scale):
    vd = M._dft_digit_matrix(P, root, F)
    if F < 64:
        pad = np.zeros((8 * F, 8, 128), dtype=np.int8)
        pad[:, :, :F] = vd.reshape(8 * F, 8, F)
        vd = pad.reshape(8 * F, 8 * 128)
    kp = jgl.pack([M._recombine_const(P)])[0]
    planes = lambda t: tuple(jnp.asarray(p) for p in i64_to_planes(t))
    scalar = None if scale is None else tuple(np.uint32(w) for w in jgl.pack([scale])[0])
    out = M._fused_level(planes(x), jnp.asarray(vd.reshape(8, F, -1)), 8, 8,
                         (np.uint32(kp[0]), np.uint32(kp[1])),
                         None if W is None else planes(W), scalar, interpret=True)
    return planes_to_i64(out)


def level_replay_matches(F, R, twiddle):
    """``level_replay`` against ``level_plain``, and (F <= 128) against the
    Pallas fused level in interpret mode, with the twiddle and a scalar."""
    root = GOLDILOCKS_FP.get_root_of_unity(F)
    x = _values((2, F, R), F + R)
    W = _values((R, F), 5) if twiddle else None
    scale = 0x123456789ABCDEF % P if twiddle else None
    vd = nd.digit_matrix(root, F, "cpu")
    got = nd.level_replay(x, vd, W, 1, scale)
    assert got.shape == (2, R, F)
    assert torch.equal(got, nd.level_plain(x, vd, W, 1, scale))
    if F <= 128:
        assert torch.equal(got, _jax_level(x, root, F, W, scale))


def digit_dot_replay_matches(B, K, R, N):
    """``digit_dot_replay`` against ``digit_dot_plain`` and numpy's int64
    product, extreme bytes included."""
    rng = np.random.default_rng(K + R + N)
    d = rng.integers(-128, 128, size=(B, K, R), dtype=np.int64).astype(np.int8)
    vd = rng.integers(-128, 128, size=(K, N), dtype=np.int64).astype(np.int8)
    d[0, :, 0], vd[:, 0] = -128, -128
    got = nd.digit_dot_replay(torch.from_numpy(d), torch.from_numpy(vd))
    want = np.einsum("bkr,kn->brn", d.astype(np.int64), vd.astype(np.int64))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, nd.digit_dot_plain(torch.from_numpy(d), torch.from_numpy(vd)))


def _banks(addr):
    return (np.asarray(addr) >> 2) & 31


def lane_maps_meet_no_bank_conflict(F):
    """The level's digitize stores (16 bytes a lane: each quarter warp on 8
    different 16-byte bank groups, the least a 512-byte warp store can
    take) and the dot's 4-byte transposing reads and stores (32 banks a
    warp, at offsets that are block_of's blocks) meet no conflict; every
    epilogue store is 16-byte aligned."""
    BM = nd.level_block_rows(F)
    for wgi in range(2 if BM == 128 else 1):
        for warp in range(4):
            tw = 32 * warp + np.arange(32)                 # thread in the warpgroup
            drow = wgi * 64 + (tw & 63)
            live = drow < BM
            for i in range(4):
                p = (tw >> 6) + 2 * i                     # the value pair, a chunk
                for kb in range(8 * F // nd.KBLOCK):
                    addr = kb * BM * nd.KBLOCK + nd.sw128(drow, 16 * p)
                    assert (addr % 16 == 0).all()
                    for quarter in range(4):
                        q = slice(8 * quarter, 8 * quarter + 8)
                        groups = ((addr[q] >> 4) & 7)[live[q]]
                        assert len(set(groups.tolist())) == len(groups)
    lane = np.arange(32)
    for it in range(64):
        cg, kg = nd.dot_block(it, lane)
        S, D = nd.dot_offsets(it % 8, lane)
        for j in range(4):
            src, dst = nd.dot_move_words(S, D, it // 8, j)
            assert np.array_equal(src, (cg >> 5) * 16384 + nd.sw128(4 * kg + j, 4 * (cg & 31)))
            assert np.array_equal(dst, nd.sw128(4 * cg + j, 4 * kg))
            assert len(set(_banks(src).tolist())) == 32
            assert len(set(_banks(dst).tolist())) == 32
    # epilogues: the level stores frequencies 32 nt + 8 c + 2 t, + 1 of a
    # row of F 8-byte values; the dot four int32 at column 8 i + 2 (t & 2)
    # of a row of N (a multiple of 128)
    t, c, nt = np.meshgrid(np.arange(4), np.arange(4), np.arange(F // 32), indexing="ij")
    k0 = nt * 32 + 8 * c + 2 * t
    assert ((k0 * 8) % 16 == 0).all() and ((F * 8) % 16 == 0)
    t, i = np.meshgrid(np.arange(4), np.arange(32), indexing="ij")
    assert (((8 * i + 2 * (t & 2)) * 4) % 16 == 0).all()
