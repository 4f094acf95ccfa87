"""The first-occurrence leaf search (commit/packed_tree.py; ROADMAP X4) on
the CPU: ``_first_match_find_plain`` against the JAX package's
``ministark_tpu/commit/packed_tree.py::_first_match_find`` (the (n, C, 2)
u32 layout there, the port's (n, C) int64 here) at C = 1, 2, 4 and q = 1,
6, 9 (over SEARCH_CHUNK) and 64 (q = 0 against the contract: the JAX
function raises on it), with duplicates, the first and last
indices, rows equal to an element in some words only, and absent rows;
the kernel's route replayed in torch ops (``_replay``: blocks, their
grid-stride passes, each thread's ring of elements in flight, the
prefilter on one 32-bit word and the confirm in all words, per-row
minima, the last block's write-back) at small geometries
against the plain version, with duplicates across blocks and inside one
thread group, rows first at every edge of the walk, elements equal to a
row in the prefilter word only before its first index, q on each side of
the rows held in registers and at MATCH_MAX_ROWS; the dispatch by device.
Tolerance 0: indices."""

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


def _prefilter(words: torch.Tensor) -> torch.Tensor:
    """The kernel's prefilter word of each element or row: word 0's low 32
    bits (a BabyBear word whole, a Goldilocks word's low half), as int64."""
    return words[..., 0].to(torch.int64) & 0xFFFFFFFF


def _replay(comps: torch.Tensor, rows: torch.Tensor, threads: int = 4, stages: int = 4,
            blocks: int = 3, seed: int = 0, reg_rows: int = pt.MATCH_REG_ROWS,
            stats: dict = None) -> torch.Tensor:
    """``first_match_cuda``'s route (csrc/leaf_search.cu) in torch ops, with
    ``blocks`` blocks of ``threads`` threads (the kernel: 256 threads, the
    blocks of one wave): thread t of block b takes elements b threads + t +
    k step (step = blocks threads: a pass over the grid), the first
    ``stages`` of them fetched into its ring's slots before anything else
    (the kernel: 4-16, 128 bytes), element k read from slot k mod stages
    and the slot refilled with element k + stages, each element once; the
    rows' prefilter words (``_prefilter``) padded with row 0's to
    ``reg_rows`` (q <= reg_rows: registers, an element compared at a time)
    or to a multiple of 4 (shared memory: 4 slots read and compared at
    once, then refilled); an element whose prefilter word equals any padded
    word is confirmed against the rows whose word it equals, in all words,
    a true match an atomicMin on that row's minimum (0xFFFFFFFF between
    calls). The blocks run in an order drawn from ``seed``; the last one
    writes n where no block hit and resets the minima. ``stats`` gets the
    elements confirmed and the confirms that found no row. Same contract
    as ``_first_match_find_plain``."""
    n, q = comps.shape[0], rows.shape[0]
    none = (1 << 32) - 1
    step = blocks * threads
    group = 1 if q <= reg_rows else 4
    assert stages % group == 0, "a group's slots lie together in the ring"
    row_pre = _prefilter(rows)
    width = reg_rows if q <= reg_rows else -(-q // 4) * 4
    padded = torch.cat([row_pre, row_pre[:1].expand(max(width - q, 0))])
    x = _prefilter(comps)
    pre_hit = (x.unsqueeze(1) == padded).any(1).tolist()
    seen = [0] * n
    scratch = torch.full((q,), none, dtype=torch.int64)
    confirmed = empty = 0
    for b in np.random.default_rng(seed).permutation(blocks):
        for t in range(threads):
            first = int(b) * threads + t
            ring = [first + k * step if first + k * step < n else None
                    for k in range(stages)]                  # the prologue's fetches
            slot = 0
            for i0 in range(first, n, group * step):
                mine = [i for i in range(i0, i0 + group * step, step) if i < n]
                for g, i in enumerate(mine):
                    if ring[slot + g] != i:
                        raise AssertionError(f"_replay: slot {slot + g} holds "
                                             f"{ring[slot + g]}, not {i}")
                    seen[i] += 1
                    if pre_hit[i]:
                        confirmed += 1
                        found = False
                        for j in torch.nonzero(row_pre == x[i]).flatten().tolist():
                            if bool((comps[i] == rows[j]).all()):
                                scratch[j] = min(int(scratch[j]), i)
                                found = True
                        empty += not found
                for g in range(group):                       # the slots' refills
                    nxt = i0 + (g + stages) * step
                    ring[slot + g] = nxt if nxt < n else None
                slot = (slot + group) % stages
    if seen != [1] * n:
        raise AssertionError("_replay: an element was not visited exactly once")
    if stats is not None:
        stats.update(confirmed=confirmed, empty_confirms=empty)
    out = torch.where(scratch == none, torch.full_like(scratch, n), scratch)
    scratch.fill_(none)                  # the last block's reset
    return out


# (threads, stages, blocks, reg_rows) of the replay: passes of 2-40 elements
# over 1-5 blocks, rings of 4-8 slots, the 12 rows of the cases below in
# registers (reg_rows 16) and in shared memory (8, 2)
REPLAY_TILES = [(4, 4, 3, 8), (2, 4, 1, 16), (8, 4, 5, 2), (4, 8, 2, 8)]


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("tile", REPLAY_TILES)
def test_first_match_replay_matches_plain(C, tile):
    """A value first at index 3 (block 0) and again in later blocks, and one
    first in block 1 with a later copy in block 0's next pass, at several
    codeword lengths (one element, part of a pass, several passes and ring
    refills), the blocks finishing in seeded orders."""
    threads, stages, blocks, reg_rows = tile
    step = threads * blocks
    t = step * stages
    for n in (1, t - 1, t + 1, 7 * t + 3, 64):
        if n < 1:
            continue
        first, later = (3 % n, min(n - 1, step + 3))
        comps, rows = _case(C, 12, n, n=n, plant=(first, later))
        if n > step + threads + 1:          # first in block 1, a copy in block 0's 2nd pass
            i, j = threads + 1, step + 1
            comps[j] = comps[i]
            rows[3] = comps[i]
        c, r = _port(comps), _port(rows)
        want = pt._first_match_find_plain(c, r)
        for seed in range(3):
            got = _replay(c, r, threads, stages, blocks, seed, reg_rows)
            assert torch.equal(got, want), (n, seed)


def test_first_match_replay_duplicate_in_one_thread_group():
    """Two copies in one thread's ring (5 and 13, a pass apart) and in
    neighbouring threads of one pass (18, 19): the least index wins."""
    comps, rows = _case(2, 4, 1, n=32, plant=(5, 13))
    comps[19] = comps[18]
    rows[3] = comps[18]
    c, r = _port(comps), _port(rows)
    want = pt._first_match_find_plain(c, r)
    assert int(want[2]) == 5 and int(want[3]) == 18
    assert torch.equal(_replay(c, r, threads=4, stages=4, blocks=2), want)


def _twin(elem: np.ndarray, word: int) -> np.ndarray:
    """``elem`` changed outside the prefilter word: word 0's high half (a
    64-bit word) or word 1 (a 32-bit one)."""
    twin = elem.copy()
    if word == 8:
        twin[0] ^= np.uint64(1 << 40)
    else:
        twin[1] ^= np.uint64(1)
    return twin


def _bb_port(a):
    """(m, C) values below 2^31 -> BabyBear's int32 storage."""
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


@pytest.mark.parametrize("word,C", [(8, 1), (8, 2), (8, 4), (4, 2), (4, 4)])
@pytest.mark.parametrize("reg_rows", [8, 2])
def test_first_match_prefilter_twin_before_first(word, C, reg_rows):
    """An element equal to a row in its prefilter word only (a Goldilocks
    word 0's high half differs, or a BabyBear word 1), placed before the
    row's true first index: its confirm finds no row, and the answer is the
    true first index. Goldilocks int64 and BabyBear int32 words, the rows in
    registers and in shared memory."""
    n, threads, stages, blocks = 96, 4, 4, 3
    rng = np.random.default_rng([23, word, C])
    top = 1 << (64 if word == 8 else 31)
    comps = rng.integers(0, top, size=(n, C), dtype=np.uint64)
    true_first, twin_at, other = 70, 9, 13
    comps[twin_at] = _twin(comps[true_first], word)
    rows = comps[[true_first, other, 0, n - 1]].copy()
    c, r = (_port(comps), _port(rows)) if word == 8 else (_bb_port(comps), _bb_port(rows))
    assert int(_prefilter(c[twin_at:twin_at + 1])[0]) == int(_prefilter(r[:1])[0])
    want = pt._first_match_find_plain(c, r)
    assert want.tolist() == [true_first, other, 0, n - 1]
    for seed in range(2):
        stats = {}
        assert torch.equal(_replay(c, r, threads, stages, blocks, seed, reg_rows, stats), want)
        assert stats["confirmed"] >= 5 and stats["empty_confirms"] >= 1


@pytest.mark.parametrize("tile", REPLAY_TILES)
def test_first_match_replay_hits_on_edges(tile):
    """A row first at each edge of the walk: index 0, block 0's last
    thread's first element, block 1's first, the last of the grid's first
    pass and the first of its second, the last element the rings hold at
    the start and the first a slot takes again, the first of the last
    pass, n - 1; each with a later copy, Goldilocks Fp2 and BabyBear Fp4
    words."""
    threads, stages, blocks, reg_rows = tile
    step = blocks * threads
    ring = stages * step
    n = ring + step + threads // 2 + 1
    edges = sorted({0, threads - 1, threads, step - 1, step, ring - 1, ring,
                    (n - 1) // step * step, n - 1})
    for word, C in ((8, 2), (4, 4)):
        rng = np.random.default_rng([23, step, stages, word])
        comps = rng.integers(0, 1 << (64 if word == 8 else 31), size=(n, C),
                             dtype=np.uint64)
        for e in edges:
            if e + step < n and e + step not in edges:
                comps[e + step] = comps[e]
        rows = comps[edges].copy()
        c, r = (_port(comps), _port(rows)) if word == 8 else (_bb_port(comps), _bb_port(rows))
        want = pt._first_match_find_plain(c, r)
        assert want.tolist() == edges
        for seed in range(2):
            assert torch.equal(_replay(c, r, threads, stages, blocks, seed, reg_rows), want)


@pytest.mark.parametrize("q", [1, 7, 8, 9, 1024])
def test_first_match_replay_row_counts(q):
    """q on each side of MATCH_REG_ROWS (rows in registers up to 8, in
    shared memory padded to a multiple of 4 beyond) and at MATCH_MAX_ROWS,
    at n = 150 with the rows of ``_case`` (first, last, duplicated, random,
    one word off, absent)."""
    comps, rows = _case(2, q, 3, n=150)
    c, r = _port(comps), _port(rows)
    want = pt._first_match_find_plain(c, r)
    assert torch.equal(_replay(c, r, threads=8, stages=4, blocks=3, seed=q), want)


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
