"""The comparison that decides ``correct``: a proof's parts against the
reference's, each part exact. Returns, by kind, how many parts differ and
how many there are; a part missing on either side differs."""

from __future__ import annotations

# the parts of each kind: keys of a proof's plain data
KINDS = {
    "shape": ("n_traces", "width", "transitions", "group_sizes", "n"),
    "roots": ("group_roots", "layer_roots"),
    "point_evals": ("point_evals",),
    "final_coeffs": ("final_coeffs", "pow_nonce"),
    "openings": ("batch_openings", "layer_openings"),
}


def _leaves(x):
    """A part's comparable leaves: lists are walked, anything else is one."""
    if isinstance(x, list):
        out = []
        for y in x:
            out += _leaves(y)
        return out
    return [x]


def compare(want: dict, got: dict) -> dict:
    """{kind: (differing, total)}; totals count the reference's leaves."""
    out = {}
    for kind, keys in KINDS.items():
        differing = total = 0
        for k in keys:
            a, b = _leaves(want.get(k)), _leaves(got.get(k))
            total += len(a)
            differing += sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        out[kind] = (differing, total)
    return out
