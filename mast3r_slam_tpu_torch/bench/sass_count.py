"""Count the SASS instructions of the BA Gram kernels (``csrc/ba_gram.cu``).

    python -m mast3r_slam_tpu_torch.bench.sass_count [--all] [--dump NAME]

Builds the library (``nvcc``, as the wrappers do), disassembles it with
``cuobjdump -sass`` (the CUDA toolkit's, else the copy Triton's package
carries) and prints, for each kernel of K4 / K5 and K4′ (every kernel with
``--all``), its static instruction count and its loops: each backward
branch, the instructions between its target and itself, and their mix by
opcode class. ``gram_tc_kernel``'s first template argument, its tile set, is
the kind of its C entries: 0 K4, 1 K5, 2 K4′c, 3 K4′d. A loop body runs once
per pixel (the tensor-core kernels, ``gram_tf32_kernel`` too, the reductions at one pixel a thread),
per tile of a thread's vector pixels (``rows_kernel``, K4′b and K4′b-fast:
its second template argument, 8 a thread; ``reduce_kernel``, K4′a and K4′b's
first design: 8 bf16 or 4 f32) or per tile (the FMA path, whose inner loop
runs once per pixel of the tile); divided by those pixels, its length is
the instruction count per pixel that the kernel's note quotes. The IEEE
division's and square root's slow paths are leaf subroutines of the
kernel: a loop's ``slow`` counts its call sites of them (one per operation
in K4′b's first design), ``CALL`` every call site (K4′b's one a pixel to
its out-of-line fallback, ``rays_rows_sum_ieee``, which ptxas also makes
a subroutine of the kernel and which calls the slow paths itself). Static counts only:
no profiler runs on the card machine. ``--dump NAME`` also prints the SASS
of the longest loop of each kernel whose name contains NAME.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

from mast3r_slam_tpu_torch import _build

KERNELS = ("gram_tc_kernel", "gram_tf32_kernel", "gram_kernel",
           "reduce_kernel", "rows_kernel", "rays_rows_sum_ieee",
           "gram_sum_kernel")
CLASSES = (
    ("MUFU", re.compile(r"^MUFU")),
    ("fp32", re.compile(r"^(FFMA|FMUL|FADD|FMNMX|FSEL|FSETP|FSET|FCHK)")),
    ("convert", re.compile(r"^(F2F|F2FP|I2F|F2I|PRMT)")),
    ("global load", re.compile(r"^(LDG|LD\b|LDC)")),
    ("shared", re.compile(r"^(STS|LDS|LDSM)")),
    ("mma", re.compile(r"^HMMA")),
    ("int/addr", re.compile(r"^(IMAD|IADD|LEA|SHF|LOP|ISETP|IMNMX|SEL|MOV|"
                            r"S2R|S2UR|ULDC|UMOV|UIADD|ULEA|USHF|ULOP|"
                            r"UIMAD|CS2R|R2UR)")),
    ("branch/sync", re.compile(r"^(BRA|CALL|RET|EXIT|BAR|WARPSYNC|BSSY|"
                               r"BSYNC|NANOSLEEP|VOTE|SHFL)")),
)
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
_CALL = re.compile(r"^CALL\S*\s+(?:(0x[0-9a-f]+)|`\(([^)]*)\))")


def find_tool(name: str) -> str:
    """``name`` from PATH, the CUDA toolkit or Triton's package."""
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and Path(cand).is_file():
            return cand
    try:
        import triton

        cand = Path(triton.__file__).parent / "backends/nvidia/bin" / name
        if cand.is_file():
            return str(cand)
    except ImportError:
        pass
    raise RuntimeError(f"{name} not found (CUDA toolkit or Triton's copy)")


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def _unpredicated(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return " ".join(words)


def opcode(text: str) -> str:
    """The opcode of one SASS line's instruction (predicate dropped)."""
    words = _unpredicated(text).split()
    return words[0] if words else ""


def _leaf(insns, target):
    """Whether the subroutine at ``target`` (an address or a label of the
    function ``insns``) returns without a call of its own."""
    start = next((i for i, (a, _, lab) in enumerate(insns)
                  if target in (hex(a), lab)), None)
    if start is None:
        return False
    for _, text, _ in insns[start:]:
        op = opcode(text)
        if op.startswith("CALL"):
            return False
        if op.startswith("RET"):
            return True
    return False


def calls(texts, insns=()):
    """``(call sites, slow-path call sites)`` among SASS lines of the
    function ``insns``: every ``CALL``, and those to a leaf subroutine of
    it (the IEEE division's and square root's slow paths; K4′b's
    out-of-line fallback calls those itself)."""
    slow = n = 0
    for t in texts:
        m = _CALL.match(_unpredicated(t))
        if m:
            n += 1
            slow += _leaf(insns, m.group(1) or m.group(2))
    return n, slow


def classify(ops):
    mix = {}
    for op in ops:
        name = next((c for c, rx in CLASSES if rx.match(op)), "other")
        mix[name] = mix.get(name, 0) + 1
    return mix


def parse(sass: str):
    """``{mangled name: [(address, text, label or None)]}`` of every
    function in a ``cuobjdump -sass`` listing."""
    funcs, cur, label = {}, None, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
            label = None
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            label = m.group(1)
            continue
        m = _INSN.search(line)
        if m:
            cur.append((int(m.group(1), 16), m.group(2), label))
            label = None
    return funcs


def loops(insns):
    """Backward branches: ``(start, end)`` instruction indices of each loop
    body, target to branch inclusive."""
    by_label = {lab: i for i, (_, _, lab) in enumerate(insns) if lab}
    by_addr = {a: i for i, (a, _, _) in enumerate(insns)}
    out = []
    for i, (_, text, _) in enumerate(insns):
        if opcode(text) != "BRA":
            continue
        m = _TARGET.search(text)
        if not m:
            continue
        j = (by_label.get(m.group(1)) if m.group(1)
             else by_addr.get(int(m.group(2), 16)))
        if j is not None and j < i:
            out.append((j, i))
    return out


def report(lib: Path, keep_all=False, dump=None):
    sass = subprocess.run([find_tool("cuobjdump"), "-sass", str(lib)],
                          text=True, capture_output=True, check=True).stdout
    funcs = parse(sass)
    names = demangle(list(funcs))
    rows = []
    for mangled, insns in funcs.items():
        name = names[mangled]
        if not keep_all and not any(k in name for k in KERNELS):
            continue
        ops = [opcode(t) for _, t, _ in insns if opcode(t) != "NOP"]
        body = []
        spans = loops(insns)
        if dump and dump in name and spans:
            s, e = max(spans, key=lambda se: se[1] - se[0])
            print(f"--- {name}: longest loop")
            for _, text, _ in insns[s:e + 1]:
                print("   ", text)
        for s, e in spans:
            texts = [t for _, t, _ in insns[s:e + 1] if opcode(t) != "NOP"]
            lops = [opcode(t) for t in texts]
            n_calls, n_slow = calls(texts, insns)
            body.append(dict(length=len(lops), mix=classify(lops),
                             calls=n_calls, slow=n_slow))
        rows.append(dict(kernel=name, instructions=len(ops),
                         mix=classify(ops), loops=body))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--all", action="store_true",
                    help="every function of the library, not only the "
                    "Gram kernels")
    ap.add_argument("--dump", metavar="NAME",
                    help="print the longest loop of the kernels whose "
                    "name contains NAME")
    args = ap.parse_args(argv)
    lib = _build.build_all(["ba_gram"], log=print)["ba_gram"]
    rows = report(lib, args.all, args.dump)
    for r in rows:
        print(f"{r['kernel']}: {r['instructions']} instructions {r['mix']}")
        for k, lp in enumerate(r["loops"]):
            print(f"    loop {k}: {lp['length']} instructions, "
                  f"{lp['calls']} CALL ({lp['slow']} slow-path), "
                  f"{lp['mix']}")
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
