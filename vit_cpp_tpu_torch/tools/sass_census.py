"""Instruction census of the port's CUDA kernels, on the machine with nvcc.

Compiles csrc/*.cu with the library's flags (_build.NVCC_FLAGS), each
source by its own nvcc and all of them at once as the build does, into
cubins; reads each __global__ instantiation's SASS (cuobjdump -sass) and
ptxas's report (-Xptxas -v), and prints one line per kernel: its SASS
instructions, its tensor-core instructions by kind (HGMMA and IGMMA, the
asynchronous warpgroup products of wgmma in f16/bf16 and in s8; HMMA and
IMMA, the warp-level ones of mma.sync), its registers and its spill
bytes. With --against DIR (another tree's csrc/, for example the
parent commit's unpacked by `git archive`) it compiles that tree too and
prints, for each kernel both trees have, whether the two have the same
opcode sequence (else at how many positions it differs, and how many
opcodes one has that the other lacks):

    python -m vit_cpp_tpu_torch.tools.sass_census [--against OLD/csrc] [--sources FILE.cu ...]

Kernels are keyed by name and template arguments (`attention_mma<4>`,
`grad_rows_mma<__nv_bfloat16, 4>`), demangled by the toolkit's cu++filt
and stripped of namespaces, so a kernel that moved to another namespace
still pairs with its old self. Each tree's line `build` gives the wall
seconds of its parallel compile and each source's own seconds.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

from vit_cpp_tpu_torch._build import CSRC, NVCC_FLAGS, _nvcc

_INSN = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def compile_tree(csrc: str, out: str, only=None) -> tuple:
    """Every .cu of `csrc` (or those named in `only`) to a cubin in `out`,
    all at once; (cubins, ptxas's report, wall seconds, {source: seconds})."""
    nvcc = _nvcc()
    flags = [f for f in NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    srcs = sorted(f for f in os.listdir(csrc) if f.endswith(".cu") and (not only or f in only))

    def one(src):
        t0 = time.perf_counter()
        cmd = [nvcc, *flags, "-cubin", "-o", os.path.join(out, src + ".cubin"),
               os.path.join(csrc, src)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}")
        return proc.stdout, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(srcs)) as pool:
        done = list(pool.map(one, srcs))
    return ([os.path.join(out, src + ".cubin") for src in srcs], "".join(o for o, _ in done),
            time.perf_counter() - t0, {src: t for src, (_, t) in zip(srcs, done)})


def ptxas_usage(log: str) -> dict:
    """{mangled name: (registers, spill store bytes, spill load bytes)}."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spills)
            name = None
    return out


# the tensor-core opcodes, counted apart
TENSOR_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA")


def tensor_ops(ops: list) -> dict:
    """{kind: count} of a kernel's tensor-core instructions (an opcode
    `HGMMA.64x128x16.F32.BF16` is of kind HGMMA)."""
    kinds = [o.split(".")[0] for o in ops]
    return {k: kinds.count(k) for k in TENSOR_OPS}


def tensor_text(ops: list) -> str:
    return ", ".join(f"{n} {k}" for k, n in tensor_ops(ops).items())


def sass_opcodes(cubin: str) -> dict:
    """{mangled name: [opcode of each SASS instruction]} of a cubin."""
    return parse_sass(subprocess.run(
        [os.path.join(os.path.dirname(_nvcc()), "cuobjdump"), "-sass", cubin],
        capture_output=True, text=True, check=True,
    ).stdout)


def parse_sass(dump: str) -> dict:
    """{mangled name: [opcode of each SASS instruction]} of cuobjdump -sass's
    text."""
    out, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INSN.match(line)
        if m and name:
            words = m.group(1).split()
            if words[0].startswith("@"):  # a predicate guard
                words = words[1:]
            out[name].append(words[0])
    return out


def demangle(names: list) -> dict:
    """{mangled name: its C++ signature}, by the toolkit's cu++filt."""
    out = subprocess.run(
        [os.path.join(os.path.dirname(_nvcc()), "cu++filt"), *names],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()
    if len(out) != len(names):
        raise RuntimeError(f"cu++filt gave {len(out)} lines for {len(names)} names")
    return dict(zip(names, out))


def short_name(signature: str) -> str:
    """`name<template arguments>` of a kernel's C++ signature: without its
    namespaces (nvcc names an anonymous namespace after the file and a
    hash; cu++filt prints it `<unnamed>`), the casts cu++filt puts before
    integer arguments (`(int)4`), its return type and its parameters."""
    bare = re.sub(r"(\(anonymous namespace\)|<unnamed>|\w+)::", "", signature)
    bare = re.sub(r"\((?:unsigned |signed )?\w+\)(?=-?\d)", "", bare)
    return bare.removeprefix("void ").split("(")[0].strip()


def census(csrc: str, only=None) -> tuple:
    """({kernel: (opcodes, registers, spill stores, spill loads)}, wall s,
    {source: s})."""
    with tempfile.TemporaryDirectory() as tmp:
        cubins, log, wall, seconds = compile_tree(csrc, tmp, only)
        usage = ptxas_usage(log)
        ops = {}
        for c in cubins:
            ops.update(sass_opcodes(c))
    names = demangle(sorted(ops))
    return ({short_name(names[m]): (ops[m], *usage.get(m, (-1, -1, -1))) for m in ops}, wall,
            seconds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another tree's csrc/ to compare with")
    ap.add_argument("--sources", nargs="*", default=None,
                    help="the .cu files to compile (default: all of them)")
    args = ap.parse_args(argv)
    trees = [("new", CSRC)] + ([("old", args.against)] if args.against else [])
    got = {}
    for label, csrc in trees:
        got[label], wall, seconds = census(csrc, args.sources)
        each = ", ".join(f"{s} {t:.1f}" for s, t in sorted(seconds.items()))
        print(f"build {label} {csrc}: {wall:.1f} s wall in parallel ({each})", flush=True)
    for key in sorted(set(got["new"]) | set(got.get("old", {}))):
        if key not in got["new"]:
            o_ops, o_regs, o_st, o_ld = got["old"][key]
            print(f"kernel {key}: only in old: {len(o_ops)} instructions, "
                  f"{tensor_text(o_ops)}, {o_regs} registers, spills {o_st}/{o_ld}", flush=True)
            continue
        ops, regs, st, ld = got["new"][key]
        line = (f"kernel {key}: {len(ops)} instructions, {tensor_text(ops)}, {regs} registers, "
                f"spills {st}/{ld} bytes (stores/loads)")
        old = got.get("old", {}).get(key)
        if old is not None:
            o_ops, o_regs, o_st, o_ld = old
            diff = sum(a != b for a, b in zip(ops, o_ops)) + abs(len(ops) - len(o_ops))
            moved = sum(((Counter(ops) - Counter(o_ops)) + (Counter(o_ops) - Counter(ops))).values())
            line += (f" | old: {len(o_ops)} instructions, {tensor_text(o_ops)}, "
                     f"{o_regs} registers, spills {o_st}/{o_ld}; opcode sequence "
                     + ("identical" if ops == o_ops else
                        f"differs at {diff} positions, {moved} opcodes not in the other's multiset"))
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
