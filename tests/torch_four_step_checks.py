"""The four-step kernels' route, replayed in torch ops
(``ntt_four_step.pass1_replay`` / ``pass2_replay`` / ``transform_replay``),
held to the Pallas passes, to the plain passes and to ``pow`` for the
kernels' tables: one body per check, which tests/test_torch_ntt_backends.py
(Goldilocks) and tests/test_torch_bb_ntt.py (BabyBear) call with the field,
its coset offset and the JAX package's outputs. Exact: tolerance 0."""

import torch

from ministark_tpu_torch.ops import ntt
from ministark_tpu_torch.ops import ntt_four_step as fs

U64 = 1 << 64


def four_step_cases(field, shift):
    """(inverse, pre, post): the four transforms, as the passes take them."""
    return ((False, None, None), (True, None, None), (False, shift, None),
            (True, None, field.inv(shift)))


def replay_matches_pallas(x, want, batch, shift, field):
    """The replayed transforms of the first ``batch`` rows of ``x`` against
    ``want``: the Pallas outputs of fft(x), ifft(x), coset_fft(x, s) and
    coset_ifft(x, s^-1). Where fft and ifft are None (only the coset entry
    points ran), fft of x s^i is held against coset_fft(x, s) and ifft(x)
    s^-i against coset_ifft(x, s^-1)."""
    F = ntt.ntt_field(field)
    x, n = x[:batch], x.shape[1]
    fwd, bwd, cfwd, cbwd = (None if w is None else w[:batch] for w in want)
    inv = field.inv(shift)
    assert torch.equal(fs.transform_replay(x, False, shift, None, field), cfwd)
    assert torch.equal(fs.transform_replay(x, True, None, inv, field), cbwd)
    if fwd is None:
        pw = ntt.powers_plain(field, shift, n, x.device)
        pw_inv = ntt.powers_plain(field, inv, n, x.device)
        assert torch.equal(fs.transform_replay(F.mul(x, pw), field=field), cfwd)
        assert torch.equal(F.mul(fs.transform_replay(x, True, field=field), pw_inv),
                           cbwd)
    else:
        assert torch.equal(fs.transform_replay(x, field=field), fwd)
        assert torch.equal(fs.transform_replay(x, True, field=field), bwd)


def replay_passes_match_plain(x, shift, field):
    """Each replayed pass against its plain version (the specification) on
    (batch, n) ``x``, pass 2 with the scale and the post power together."""
    n = x.shape[1]
    for inverse, pre, post in four_step_cases(field, shift):
        tw1, tw2, wpow = fs._tables(n, inverse, "cpu", field)
        c = fs.pass1_plain(x, tw2, wpow, pre, field)
        assert torch.equal(fs.pass1_replay(x, tw2, wpow, pre, field), c)
        scale = ntt.inv_n(field, n) if inverse else None
        assert torch.equal(fs.pass2_replay(c, tw1, scale, post, field),
                           fs.pass2_plain(c, tw1, scale, post, field))


def kernel_tables_match_pow(log_n, shift, field):
    """The tables the kernels read, at their boundary indices: the stage
    roots of w1 and w2, pass 1's split twiddle w^e (e < n, across the split
    at n1 and the sign of w2^(n2/2) = -1) and the coset tables with 1/n in
    hi."""
    n, P = 1 << log_n, field.p
    n1, n2 = fs._split_sizes(n)
    for inverse in (False, True):
        w = ntt._roots(field, n, inverse)
        tw1, tw2, wpow = fs._tables(n, inverse, "cpu", field)
        for tw, m in ((tw1, n1), (tw2, n2)):
            roots, lo, hi = fs._kernel_tables(tw, None, log_n, "cpu", field)
            assert lo is None and hi is None and roots.shape == (m // 2,)
            for j in (0, 1, m // 2 - 1):
                assert int(roots[j]) % U64 == pow(w, j * (n // m), P)
        es = [0, 1, n1 - 1, n1, n1 + 1, n // 2 - 1, n // 2, n // 2 + n1 + 1,
              (n1 - 1) * (n2 - 1)]
        got = fs._split_twiddle(torch.tensor(es), wpow, tw2[-1], ntt.ntt_field(field))
        assert [int(v) % U64 for v in got] == [pow(w, e, P) for e in es]
        scale = ntt.inv_n(field, n)
        _, lo, hi = fs._kernel_tables(tw1, shift, log_n, "cpu", field, scale)
        h = ntt.coset_split(log_n)
        for i in (0, 1, (1 << h) - 1, 1 << h, (1 << h) + 1, n - 1):
            got = int(lo[i & ((1 << h) - 1)]) % U64 * (int(hi[i >> h]) % U64)
            assert got % P == pow(shift, i, P) * scale % P, i
