#!/usr/bin/env python3
"""The instruction mix of the v1-v3 rung kernels' builds, from their SASS.

    python3 scripts/torch_rung_sass.py [--lib PATH] [--opcodes]

Builds the port's kernels (`_build.build`, or takes `--lib`), disassembles
the library with the toolkit's `cuobjdump -sass` and, for each build of
`advect_blocked_kernel` (K3) and `advect_dataflow_kernel` (K2, `wide` its
16-byte build), counts the instructions of the classes that say how a bf16
op is computed and rounded: `F2F` (a convert on the conversion unit),
`F2FP` (a paired convert, `rpk` and `bf16_pack`), the bf16x2 ops
(`HADD2.BF16_V2`, `HMUL2.BF16_V2`, and `HFMA2.BF16_V2` or
`HFMA2.MMA.BF16_V2`, an add or a product with a unit operand), the f32
ops (`FADD`,
`FMUL`, `FFMA`), byte permutes (`PRMT`), shared loads (`LDS`), local
loads and stores (`LDL`, `STL`: spills) and all instructions. A build is
named by its template arguments: the cell (f32 or bf16), the coefficient
storage (CB) and the cells a run (VEC: 1 one cell, 2 one bf16 pair, 4 or
8 a 16-byte vector). Counts are static (instructions in the code, not
executed). `--opcodes` also prints each bf16 build's count of every
opcode. Needs the CUDA toolkit (`nvcc`'s directory holds `cuobjdump`).
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import _build  # noqa: E402

KERNELS = ("advect_blocked_kernel", "advect_dataflow_kernel")
CLASSES = (
    ("F2F", re.compile(r"\bF2F\.")),
    ("F2FP", re.compile(r"\bF2FP\.")),
    ("HADD2.BF16", re.compile(r"\bHADD2\.BF16")),
    ("HMUL2.BF16", re.compile(r"\bHMUL2\.BF16")),
    ("HFMA2.BF16", re.compile(r"\bHFMA2\.(MMA\.)?BF16")),
    ("FADD", re.compile(r"\bFADD\b")),
    ("FMUL", re.compile(r"\bFMUL\b")),
    ("FFMA", re.compile(r"\bFFMA\b")),
    ("PRMT", re.compile(r"\bPRMT\b")),
    ("LDS", re.compile(r"\bLDS(\.|\s)")),
    ("LDL/STL", re.compile(r"\b(LDL|STL)(\.|\s)")),
)
# the template arguments in a build's mangled name: cell, CB, VEC
ARGS = re.compile(r"kernelI(13__nv_bfloat16|f)Lb([01])ELi(\d+)E")
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?);")


def sass_functions(lib: Path) -> dict:
    """{mangled name: [instruction text]} of every kernel in the library."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            out[name] = []
        elif name is not None:
            m = INSTR.search(line)
            if m:
                out[name].append(m.group(1))
    return out


def build_label(name: str) -> str | None:
    kernel = next((k for k in KERNELS if k in name), None)
    m = ARGS.search(name)
    if kernel is None or m is None:
        return None
    cell = "bf16" if m.group(1) != "f" else "f32"
    return (f"{kernel} {cell} CB={m.group(2)} VEC={m.group(3)}")


def mix(instrs) -> Counter:
    c = Counter({"total": len(instrs)})
    for text in instrs:
        for label, pat in CLASSES:
            if pat.search(text):
                c[label] += 1
    return c


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", type=Path, default=None,
                    help="the built library (default: build it)")
    ap.add_argument("--opcodes", action="store_true",
                    help="also each bf16 build's count of every opcode")
    args = ap.parse_args()
    lib = args.lib or _build.build()
    rows, opcodes = [], []
    for name, instrs in sass_functions(lib).items():
        label = build_label(name)
        if label:
            rows.append((label, mix(instrs)))
            if args.opcodes and " bf16 " in label:
                ops = Counter(t.split()[0] if not t.startswith("@")
                              else t.split()[1] for t in instrs)
                opcodes.append((label, ops))
    if not rows:
        print("torch_rung_sass: no rung kernel found in the SASS",
              file=sys.stderr)
        return 1
    keys = ["total"] + [label for label, _ in CLASSES]
    print("build | " + " | ".join(keys))
    for label, c in sorted(rows):
        print(f"{label} | " + " | ".join(str(c[k]) for k in keys),
              flush=True)
    for label, ops in sorted(opcodes):
        print(f"{label}: " + ", ".join(f"{op} {n}" for op, n in
                                       ops.most_common()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
