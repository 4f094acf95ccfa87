"""The fused digit level at F = 32 with padded digit planes, bit-checked.

The port's twin of scripts/tpu_f32_pad_probe.py: one NTT level in its
digit-matmul form at B = 2, F = 32, R = 4096 (the last level of 2^17), the
digit matrix scattered into (8 F, 8 x 128) so that plane b starts at column
b x 128 while its width stays 32, no twiddle. The fused CUDA kernel
(``ntt_digit.level_cuda``) is held against the plain version
(``level_plain``) on the same input; PASS and exit 0 when they are equal.

    python3 scripts/torch_f32_pad_probe.py           # on the GPU host
    python3 scripts/torch_f32_pad_probe.py --device cpu --rows 64   # dry run
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ministark_tpu_torch.fields import GOLDILOCKS_FP
from ministark_tpu_torch.ops import ntt_digit

FQ, PF, BATCH = 32, 128, 2


def run(rows=4096, device="cuda", seed=5):
    """(ok, mismatches, values): the level on ``device`` against the plain
    version on the same tensor."""
    p = GOLDILOCKS_FP.p
    vd = ntt_digit.digit_matrix(GOLDILOCKS_FP.get_root_of_unity(FQ), FQ, device, PF)
    assert tuple(vd.shape) == (8 * FQ, 8 * PF)
    rng = np.random.default_rng(seed)
    v = rng.integers(0, p, size=(BATCH, FQ, rows), dtype=np.uint64)
    v.reshape(-1)[:5] = (0, 1, ntt_digit.GL_CENTER_T, ntt_digit.GL_CENTER_T + 1, p - 1)
    x = torch.from_numpy(v.view(np.int64)).to(device)
    got = ntt_digit.level(x, vd)
    want = ntt_digit.level_plain(x, vd)
    bad = int((got != want).sum())
    return bad == 0, bad, got.numel()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=4096)
    args = ap.parse_args(argv)
    ok, bad, total = run(args.rows, args.device)
    if ok:
        print(f"PASS: padded-column F=32 level bit-exact on {args.device}")
    else:
        print(f"FAIL: {bad}/{total} mismatches")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
