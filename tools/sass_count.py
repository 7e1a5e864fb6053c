#!/usr/bin/env python3
"""Count the machine instructions of the sweep kernels, and of each
kernel's plane loop, in a built kernel library.

    python3 tools/sass_count.py [--root TREE] [--match REGEX] [--ops]

Builds ``TREE``'s kernels (this tree by default) with ``_build.build``,
disassembles them with ``cuobjdump -sass`` and prints one JSON line per
kernel whose mangled name matches ``REGEX``: its instruction count, and
for its largest loop (the span from a backward branch's target to the
branch: the x-plane loop of a march) the instructions it issues a pass,
with ``--ops`` by opcode. A march's plane loop issues that count a plane
for each warp, so the count over the points a warp owns a plane is the
number to compare between two designs. A K1 kernel (f32 or bf16 stores)
also names the sources of B it serves: each kind's form is the kernel that
serves it. Needs nvcc and cuobjdump (a CUDA toolkit), not a card.
"""

import argparse
import collections
import json
import re
import sys
from pathlib import Path

# compare_launches.py copies itself into the tree it compares with, so the
# parser lives there and this file takes it from there
from compare_launches import parse_sass, sass_text

ROOT = Path(__file__).resolve().parent.parent


def kernels(lib):
    """{mangled name: [(address, instruction)]} of every function in ``lib``."""
    return parse_sass(sass_text(lib))


def largest_loop(code):
    """(first address, last address) of the widest backward branch's span."""
    best = None
    for addr, ins in code:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            span = (int(m.group(1), 16), addr)
            if best is None or span[1] - span[0] > best[1] - best[0]:
                best = span
    return best


def loop_body(code):
    """The instructions of ``code``'s largest loop (empty without a loop)."""
    span = largest_loop(code)
    return [] if span is None else [ins for addr, ins in code if span[0] <= addr <= span[1]]


def kinds_of(name):
    """The sources of B the K1 kernel ``name`` serves (f32 or bf16 stores):
    Coulomb, SimpleCornell and Periodic for a costly-B kernel
    (``sweep_step_costly_kernel``, ``sweep_step_bf16_costly_kernel`` and
    the many-state ``sweep_step(_bf16)_many_costly_kernel``), every kind for
    the wide route's (``sweep_step(_bf16)_wide_kernel``), the others for
    the rest of K1's kernels; None for another kernel."""
    if re.search(r"\dsweep_step(?:_bf16)?_wide_kernelI", name):
        return ["NoPotential", "Harmonic", "Coulomb", "SimpleCornell", "Periodic", "streamed"]
    m = re.search(r"\d(sweep_step(?:_bf16)?(?:_many)?(_costly)?_kernel)I", name)
    if m is None:
        return None
    return ["Coulomb", "SimpleCornell", "Periodic"] if m[2] else ["NoPotential", "Harmonic",
                                                                  "streamed"]


def opcode(ins):
    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)  # the predicate
    return ins.split()[0].split(".")[0]


def main(argv):
    ap = argparse.ArgumentParser(prog="sass_count.py")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--match", default="sweep_step")
    ap.add_argument("--ops", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from wafer_torch.ops import _build

    lib = _build.build()
    for name, code in sorted(kernels(lib).items()):
        if not re.search(args.match, name):
            continue
        row = {"kernel": name, "instructions": len(code)}
        if kinds_of(name):
            row["serves"] = kinds_of(name)
        body = loop_body(code)
        if body:
            row["loop"] = len(body)
            if args.ops:
                row["loop_ops"] = dict(collections.Counter(map(opcode, body)).most_common())
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
