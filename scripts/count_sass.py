#!/usr/bin/env python3
"""Count the SASS instructions of each kernel in a built library or cubin,
by opcode, with the CUDA toolkit's ``cuobjdump``: the size of the code a
kernel's warps have to fetch, which bounds fully unrolled register kernels
such as ``csrc/fused_lml.cu``.

Run on a machine with the toolkit, after a build (``_cuda.build``):

    python3 scripts/count_sass.py gaussian_process_transportation_tpu_torch/_build/libfused_lml-*.so

One line per kernel: the end of its mangled name, its instruction count and
its eight most frequent opcodes.
"""
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path


def cuobjdump() -> str:
    for path in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if path and Path(path).is_file():
            return path
    sys.exit("count_sass: cuobjdump not found")


def counts(binary: str):
    """[(kernel name, Counter of opcodes)] of ``binary``'s SASS."""
    sass = subprocess.run([cuobjdump(), "-sass", binary], capture_output=True, text=True,
                          check=True).stdout
    kernels = []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernels.append((m.group(1), collections.Counter()))
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and kernels:
            ins = m.group(1).strip()
            if ins.startswith("@"):  # a predicate guard
                ins = ins.split(None, 1)[1]
            kernels[-1][1][ins.split()[0].split(".")[0]] += 1
    return kernels


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for binary in sys.argv[1:]:
        for name, ops in counts(binary):
            print(f"{name[-45:]} {sum(ops.values())} {dict(ops.most_common(8))}")


if __name__ == "__main__":
    main()
