"""The system under test for the fast-mode configurations: the port's
``FastStark.prove_many`` over device-built traces, one proof a call.

The benchmark takes from the program only this entry and its trace
constructor; the proof comes back as the program's objects, which ``parts``
reads into plain data for the comparison with the reference.
"""

from __future__ import annotations

import torch

from .. import roofline as rf
from ..reference import fast_stark as reference

PROVER_KEYS = ("queries", "point_queries", "blowup", "arity", "fold_factor", "final_len",
               "grinding_bits")
TAG = {"goldilocks": "gl", "babybear": "bb"}
DEGREE = {"goldilocks": 2, "babybear": 4}
WIDTH, TRANSITIONS = 3, 3            # the Fibonacci AIR's columns and constraints


def _flat(x):
    if isinstance(x, tuple):
        return tuple(c for y in x for c in _flat(y))
    return (int(x),)


def _paths(paths):
    return [(p.row, list(p.groups)) for p in paths]


class System:
    def __init__(self, config: dict, mix: dict, device):
        from ministark_tpu_torch.fields import BabyBear, Goldilocks
        from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
        from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig

        if config["air"] != "fibonacci" or config["lde_backend"] != "fri":
            raise ValueError("this system proves the Fibonacci AIR with batched FRI")
        self.config, self.mix = config, mix
        self.field = config["field"]
        self.sf = {"goldilocks": Goldilocks, "babybear": BabyBear}[self.field]
        self.steps = mix["steps"]
        self.device = torch.device(device)
        self.cfg = {k: config[k] for k in PROVER_KEYS}
        self._trace = fibonacci_device_trace
        self.prover = FastStark(FastStarkConfig(self.sf, self.steps, lde_backend="fri", **self.cfg),
                                device=device, ntt_backend=config["ntt_backend"])
        self.n = 1 << self.steps.bit_length()
        self.attempts = []

    def rows_per_call(self) -> int:
        return self.mix["traces_per_call"] * self.n

    def call(self, secrets):
        """One prove of the statements: the traces' builds (one witness
        launch each, on first read) and prove_many."""
        traces = [self._trace(self.sf, self.steps, secret_b=b, on_device=True,
                              device=self.device) for b in secrets]
        proof = self.prover.prove_many(traces)
        nonce = proof.fri_proof.pow_nonce
        self.attempts.append(int.from_bytes(nonce, "little") + 1 if nonce else 0)
        return proof

    def reset_notes(self):
        self.attempts = []

    def notes(self, call_ms) -> str:
        """A line for the run's log: the grind's hashes a call (the nonce
        found, plus one), which the statements fix, and the least-squares
        line of the window's call times on them: how much of a call's time
        the grind explains, and what the rest spreads by."""
        a = self.attempts
        if not a or not max(a) or len(a) != len(call_ms) or len(a) < 3:
            return ""
        n = len(a)
        ma, mt = sum(a) / n, sum(call_ms) / n
        var = sum((x - ma) ** 2 for x in a)
        slope = sum((x - ma) * (y - mt) for x, y in zip(a, call_ms)) / var if var else 0.0
        rest = sorted(y - slope * x for x, y in zip(a, call_ms))
        q = lambda v, f: v[min(len(v) - 1, int(f * len(v)))]  # noqa: E731
        top = sorted(range(n), key=lambda i: -call_ms[i])[:5]
        return (f"grind: hashes a call mean {ma:.0f}, p95 {q(sorted(a), 0.95)}; call ms = "
                f"{mt - slope * ma:.2f} + {slope * 1e3:.4f} us x hashes; the rest's median "
                f"{q(rest, 0.5):.2f}, p95 {q(rest, 0.95):.2f}, max {rest[-1]:.2f} ms; longest "
                f"calls (index, ms, hashes) {[(i, round(call_ms[i], 1), a[i]) for i in top]}")

    def mark_phases(self, record_function):
        """Open a ``phase:<label>`` range at each of the prover's phase
        boundaries (its ``_t``), for the traced run's breakdown; a prover
        without them is left as it is."""
        orig = getattr(self.prover, "_t", None)
        if orig is None:
            return
        state = {"open": None}

        def t(label):
            if state["open"] is not None:
                state["open"].__exit__(None, None, None)
                state["open"] = None
            orig(label)
            if label != "end":
                state["open"] = record_function("phase:" + label)
                state["open"].__enter__()

        self.prover._t = t

    def release(self):
        """Free the program's state before the reference runs."""
        self.prover = None

    @staticmethod
    def parts(proof) -> dict:
        fp = proof.fri_proof
        return {
            "n_traces": proof.n_traces, "width": proof.width,
            "transitions": proof.transitions,
            "point_evals": [[_flat(e) for e in ev] for ev in proof.point_evals],
            "group_sizes": list(fp.group_sizes), "n": fp.n,
            "group_roots": list(fp.group_roots), "layer_roots": list(fp.layer_roots),
            "final_coeffs": [_flat(c) for c in fp.final_coeffs], "pow_nonce": fp.pow_nonce,
            "batch_openings": [_paths(q) for q in fp.batch_openings],
            "layer_openings": [_paths(q) for q in fp.layer_openings],
        }

    def reference(self, secrets, control: bool = False) -> dict:
        return reference.prove(self.field, self.steps, secrets, self.cfg, self.device,
                               control=control)

    def work(self):
        """(bytes, ops) of a call's compulsory device work: the transforms
        (the trace's inverse, the commitments' low-degree extensions, each
        FRI layer's) and the SHA-256 of every committed row and tree node,
        at this cell's sizes. Fixed by the protocol, whatever kernels run."""
        tag, d = TAG[self.field], DEGREE[self.field]
        B, n = self.mix["traces_per_call"], self.n
        c = self.cfg
        N, F, arity = c["blowup"] * n, c["fold_factor"], c["arity"]
        P = B * (WIDTH + TRANSITIONS)
        pieces = [
            rf.ntt_work(WIDTH * B, n, True, tag),              # trace -> coefficients
            rf.ntt_work(P, N, False, tag),                      # witness LDE (base values)
            rf.tree_work(N // F, 8 * P * F * d, arity),         # its rows: d components a value
            rf.ntt_work(B * d, N, False, tag),                  # validity LDE
            rf.tree_work(N // F, 8 * B * F * d, arity),
        ]
        m, Nn = n, N
        while m // F > c["final_len"]:
            m, Nn = m // F, Nn // F
            pieces += [rf.ntt_work(d, Nn, False, tag), rf.tree_work(Nn // F, 8 * F * d, arity)]
        return sum(p[0] for p in pieces), sum(p[1] for p in pieces)
