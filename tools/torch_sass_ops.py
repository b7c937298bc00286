#!/usr/bin/env python
"""Instruction counts by opcode of the port's kernels, on a machine with the
CUDA toolkit.

    python tools/torch_sass_ops.py cross_attn_fwd_tcILi128 cross_attn_bwd_tcILi128

Builds the kernels of this checkout (`ops/_kernels.build`), disassembles the
library with `cuobjdump -sass` and prints, for each function whose mangled
name contains one of the given patterns, its static instruction count and
the most frequent opcodes (the mnemonic before the first dot). The counts
are static: a loop body counts once.
"""

import collections
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from smow_net_tpu_torch.ops import _kernels  # noqa: E402


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_kernels.build())], capture_output=True,
                          text=True, check=True).stdout
    funcs, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            funcs[current] = collections.Counter()
        elif current is not None:
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
            if m:
                funcs[current][m.group(2)] += 1
    for pattern in sys.argv[1:]:
        for name, ops in funcs.items():
            if pattern in name:
                print(f"{pattern}: {sum(ops.values())} instructions; "
                      + ", ".join(f"{k} {v}" for k, v in ops.most_common(30)))


if __name__ == "__main__":
    main()
