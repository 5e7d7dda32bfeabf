#!/usr/bin/env python3
"""Compare the machine code (SASS) of the CUDA kernels in two source trees.

    python3 tools/compare_sass.py OLD_CSRC NEW_CSRC [SOURCE ...]

Compiles each source (default: every ``*.cu`` of ``kernels/build.py``)
from both ``csrc`` directories to a cubin with the port's nvcc flags,
disassembles both with ``cuobjdump -sass`` and prints, for every kernel
of the new tree, whether its instruction sequence equals that of some
kernel of the old tree (matched by content, not by name, so a renamed
template argument does not hide an unchanged body), with both
instruction counts where a same-named kernel exists. Needs nvcc and
cuobjdump (the CUDA toolkit), so it runs on a GPU host.
"""
import hashlib
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from repro_torch.kernels import build  # noqa: E402

FLAGS = [f for f in build.NVCC_FLAGS
         if f not in ("-shared", "-Xcompiler", "-fPIC")]


def kernels(csrc: str, source: str, cubin: str) -> dict:
    """{mangled kernel name: (instruction hash, instruction count)}."""
    subprocess.run([build.nvcc_path(), *FLAGS, "-cubin", "-o", cubin,
                    os.path.join(csrc, source)], check=True)
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        ins = re.findall(r"/\*[0-9a-f]{4}\*/\s+(.*?);", body)
        out[name] = (hashlib.sha1("\n".join(ins).encode()).hexdigest(),
                     len(ins))
    return out


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    old_dir, new_dir, sources = argv[0], argv[1], argv[2:] or build.SOURCES
    with tempfile.TemporaryDirectory() as tmp:
        for source in sources:
            old = kernels(old_dir, source, os.path.join(tmp, "old.cubin"))
            new = kernels(new_dir, source, os.path.join(tmp, "new.cubin"))
            old_bodies = {h for h, _ in old.values()}
            same = sum(h in old_bodies for h, _ in new.values())
            print(f"{source}: {len(new)} kernels ({len(old)} before), "
                  f"{same} with a body identical to one before")
            for name, (h, n) in sorted(new.items()):
                tag = "same" if h in old_bodies else "diff"
                before = old[name][1] if name in old else "-"
                print(f"  {tag} {n:5d} instr (before {before}) {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
