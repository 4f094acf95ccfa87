"""The static SASS instruction mix of the port's CUDA kernels.

Builds the kernel library (``ministark_tpu_torch/ops/cuda.py``), disassembles
it with ``cuobjdump -sass`` (beside ``nvcc``) and prints, for every kernel
whose mangled name contains ``--match``, its instruction count and the share
of each opcode (modifiers dropped: IMAD.WIDE.U32 counts as IMAD), largest
first. The count is static: each instruction once, as compiled, not as often
as it runs; the unrolled stage rounds make up most of an NTT kernel's code.
The last line is one JSON object with every count.

    python3 scripts/torch_sass_mix.py --match four_step_pass    # on the GPU host
"""

import argparse
import collections
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ministark_tpu_torch.ops import cuda

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
# "/*0120*/   @!P0 IMAD.WIDE.U32 R2, R3, 0x8, R4 ;   /* 0x... */"
_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def sass_mix(library: str, match: str) -> dict:
    """{mangled kernel name: Counter of opcodes} for the matching kernels."""
    tool = os.path.join(os.path.dirname(cuda._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    mixes, fn = {}, None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            fn = m.group(1) if match in m.group(1) else None
            if fn:
                mixes[fn] = collections.Counter()
            continue
        m = _INSTR.match(line)
        if m and fn:
            mixes[fn][m.group(1)] += 1
    return mixes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--match", default="four_step_pass")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    mixes = sass_mix(cuda.build(), args.match)
    if not mixes:
        print(f"no kernel matches {args.match!r}", file=sys.stderr)
        return 1
    out = {}
    for fn, mix in sorted(mixes.items()):
        total = sum(mix.values())
        out[fn] = {"instructions": total, "opcodes": dict(mix.most_common())}
        top = ", ".join(f"{op} {100 * k / total:.1f}%"
                        for op, k in mix.most_common(args.top))
        print(f"{fn}: {total} instructions; {top}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
