"""The first-occurrence leaf search (commit/packed_tree.py; ROADMAP X4) on
the CPU: ``_first_match_find_plain`` against the JAX package's
``ministark_tpu/commit/packed_tree.py::_first_match_find`` (the (n, C, 2)
u32 layout there, the port's (n, C) int64 here) at C = 1, 2, 4 and q = 1,
6, 9 (over SEARCH_CHUNK) and 64 (q = 0 against the contract: the JAX
function raises on it), with duplicates, the first and last
indices, rows equal to an element in some words only, and absent rows;
the kernel's route replayed in torch ops (``_replay``: blocks,
their grid-stride loads, per-row minima, the last block's write-back) at
small tiles against the plain version, with duplicates across blocks and
inside one thread group; the dispatch by device. Tolerance 0: indices."""

import numpy as np
import pytest
import torch

from ministark_tpu.commit.packed_tree import _first_match_find as j_first_match
from ministark_tpu_torch.commit import packed_tree as pt

N = 300                         # elements of the searched codeword


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(C: int, q: int, seed: int, n: int = N, plant=None):
    """(comps (n, C), rows (q, C)) as u64 numpy: random elements with planted
    duplicates; rows cycle through kinds: an element at index 0, at n - 1,
    a duplicated value (first at ``plant``'s first index), an element
    taken at random, a row equal to an element but in its last word, and
    an absent value."""
    rng = np.random.default_rng([21, C, q, seed])
    comps = rng.integers(0, 1 << 64, size=(n, C), dtype=np.uint64)
    first, later = plant if plant is not None else (17, 233 % n)
    comps[later] = comps[first]
    comps[n // 2] = comps[first]
    rows = np.empty((q, C), dtype=np.uint64)
    for j in range(q):
        kind = j % 6
        if kind == 0:
            rows[j] = comps[0]
        elif kind == 1:
            rows[j] = comps[n - 1]
        elif kind == 2:
            rows[j] = comps[later]
        elif kind == 3:
            rows[j] = comps[rng.integers(0, n)]
        elif kind == 4:
            rows[j] = comps[rng.integers(0, n)]
            rows[j, -1] ^= np.uint64(1)
        else:
            rows[j] = rng.integers(0, 1 << 64, size=C, dtype=np.uint64)
    return comps, rows


def _port(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _jax_layout(a):
    """(m, C) u64 -> the JAX package's (m, C, 2) u32 [lo, hi]."""
    return np.stack([(a & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (a >> np.uint64(32)).astype(np.uint32)], -1)


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("q", [0, 1, 6, 9, 64])
def test_first_match_plain_matches_jax(C, q):
    """q = 0: the JAX function cannot take it (its ``reshape(0, -1)`` of
    the rows raises), so it is held to the contract: an empty int64 (0,)."""
    comps, rows = _case(C, q, 0)
    got = pt._first_match_find_plain(_port(comps), _port(rows))
    if q == 0:
        assert got.dtype == torch.int64 and got.shape == (0,)
        return
    want = np.asarray(j_first_match(_jax_layout(comps), _jax_layout(rows)))
    assert got.dtype == torch.int64 and got.shape == (q,)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    if q >= 6:                    # index 0, n - 1, the duplicate's first, absent
        assert got[0] == 0 and got[1] == N - 1 and got[2] == 17 and got[5] == N


def _replay(comps: torch.Tensor, rows: torch.Tensor, threads: int = 4, unroll: int = 2,
            blocks: int = 3, seed: int = 0) -> torch.Tensor:
    """``first_match_cuda``'s route (csrc/leaf_search.cu) in torch ops, with
    ``blocks`` blocks of ``threads`` threads loading ``unroll`` elements
    each (the kernel: 256, 4 and up to 8 blocks an SM): element i is
    visited by block (i // (threads unroll)) % blocks, once; each block's
    per-row minima (the shared atomicMin) start at 0xFFFFFFFF; the blocks
    finish in an order drawn from ``seed`` and each folds its minima into
    the scratch's (one atomicMin a row it hit); the last one writes n where
    none hit and resets the scratch. Same contract as
    ``_first_match_find_plain``."""
    n, q = comps.shape[0], rows.shape[0]
    none = (1 << 32) - 1
    tile = threads * unroll
    idx = torch.arange(n, device=comps.device)
    owner = (idx // tile) % blocks
    seen = torch.zeros(n, dtype=torch.int64)
    scratch = torch.full((q,), none, dtype=torch.int64)
    for b in np.random.default_rng(seed).permutation(blocks):
        # the grid-stride loop of block b: base = b tile + t blocks tile +
        # thread, its elements base + u threads
        mine = []
        for base0 in range(b * tile, n, blocks * tile):
            for th in range(threads):
                mine += [base0 + th + u * threads for u in range(unroll)
                         if base0 + th + u * threads < n]
        mine = torch.tensor(sorted(mine), dtype=torch.int64)
        if mine.numel():
            assert bool((owner[mine] == int(b)).all())
        seen[mine] += 1
        smin = torch.full((q,), none, dtype=torch.int64)
        if mine.numel() and q:
            hits = (comps[mine].unsqueeze(0) == rows.unsqueeze(1)).all(-1)   # (q, |mine|)
            cand = torch.where(hits, mine.unsqueeze(0), torch.full_like(hits, none,
                                                                         dtype=torch.int64))
            smin = cand.amin(1)
        hit = smin != none
        scratch[hit] = torch.minimum(scratch[hit], smin[hit])
    if not bool((seen == 1).all()):
        raise AssertionError("_replay: an element was not visited exactly once")
    out = torch.where(scratch == none, torch.full_like(scratch, n), scratch)
    scratch.fill_(none)                  # the last block's reset
    return out


# (threads, unroll, blocks) of the replay: tiles of 4-16 elements over 1-5 blocks
REPLAY_TILES = [(4, 2, 3), (2, 1, 1), (8, 2, 5), (4, 4, 2)]


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("tile", REPLAY_TILES)
def test_first_match_replay_matches_plain(C, tile):
    """A value first at index 3 (block 0) and again in later blocks, and one
    first in block 1 with a later copy in block 0's next pass, at several
    codeword lengths (one element, part of a tile, several passes), the
    blocks finishing in seeded orders."""
    threads, unroll, blocks = tile
    t = threads * unroll
    for n in (1, t - 1, t + 1, 7 * t + 3, 64):
        if n < 1:
            continue
        first, later = (3 % n, min(n - 1, t * blocks + 3))
        comps, rows = _case(C, 12, n, n=n, plant=(first, later))
        if n > t * (blocks + 1) + 1:       # first in block 1, a copy in block 0's 2nd pass
            i, j = t + 1, t * blocks + 1
            comps[j] = comps[i]
            rows[3] = comps[i]
        c, r = _port(comps), _port(rows)
        want = pt._first_match_find_plain(c, r)
        for seed in range(3):
            got = _replay(c, r, threads, unroll, blocks, seed)
            assert torch.equal(got, want), (n, seed)


def test_first_match_replay_duplicate_in_one_thread_group():
    """Two copies inside one thread's unrolled loads and in neighbouring
    threads of one pass: the least index wins."""
    comps, rows = _case(2, 4, 1, n=32, plant=(5, 9))
    comps[13] = comps[12]
    rows[3] = comps[12]
    c, r = _port(comps), _port(rows)
    want = pt._first_match_find_plain(c, r)
    assert int(want[2]) == 5 and int(want[3]) == 12
    assert torch.equal(_replay(c, r, threads=4, unroll=2, blocks=2), want)


def test_first_match_dispatch_by_device():
    """CPU tensors take the plain version (no launch, no call counted); the
    kernel's wrapper refuses a CPU tensor, with or without rows."""
    comps, rows = _case(2, 6, 2)
    c, r = _port(comps), _port(rows)
    before = dict(pt.calls), dict(pt.launches)
    assert torch.equal(pt._first_match_find(c, r, torch.int64),
                       pt._first_match_find_plain(c, r))
    assert (dict(pt.calls), dict(pt.launches)) == before
    with pytest.raises(ValueError):
        pt.first_match_cuda(c, r, torch.int64)
    with pytest.raises(ValueError):
        pt.first_match_cuda(c, r[:0], torch.int64)
