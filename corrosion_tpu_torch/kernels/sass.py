"""The instruction mix of a built kernel library, by function, pipe and
loop: what ptxas made of a kernel's source.

    python -m corrosion_tpu_torch.kernels.sass LIBRARY [FUNCTION_REGEX]

runs ``cuobjdump -sass`` (beside ``nvcc``) on LIBRARY, a ``.so`` that
``kernels.build`` wrote under ``kernels/build/`` (or reads LIBRARY as a
listing when it is a ``.sass`` file that an earlier run wrote beside
its library, which needs no toolkit), and prints one JSON
object: for each function whose mangled name matches the regex (all
when none is given), its opcode counts, the same summed by execution pipe,
and every loop (a backward branch and the instructions it jumps over)
with its own counts, innermost first.

The pipes are the H100's as Nsight Compute names them, by opcode:
``alu`` (IADD3, LOP3, SHF, ISETP, ...) and ``fma`` (IMAD in every form,
FFMA, FADD, FMUL) each take a warp instruction every other clock on a
scheduler (16 lanes); a scheduler dispatches one warp instruction a
clock, so integer work is balanced when the two pipes carry equal
counts.  ``lsu`` are memory and shuffle instructions, ``uniform`` the
uniform datapath's (``U*``), ``control`` branches, barriers and special
registers; anything else is ``other``.  Needs the CUDA toolkit (the
card's machine), not a card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

from corrosion_tpu_torch import kernels

PIPES = {
    "alu": ("IADD3", "LOP3", "SHF", "ISETP", "IMNMX", "SEL", "PRMT", "LEA",
            "PLOP3", "FSETP", "FSEL", "FMNMX", "BMSK", "FLO", "POPC", "BREV",
            "SGXT", "IABS", "VIMNMX", "MOV", "P2R", "R2P", "ISCADD"),
    "fma": ("IMAD", "IMUL", "FFMA", "FADD", "FMUL", "IDP", "HFMA2", "VIADD"),
    "lsu": ("LD", "ST", "ATOM", "RED", "SHFL", "LDS", "STS", "LDG", "STG",
            "LDC", "MEMBAR", "CCTL", "ERRBAR", "MATCH"),
    "control": ("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "WARPSYNC",
                "BAR", "NOP", "YIELD", "S2R", "CS2R", "VOTE", "BPT", "JMP",
                "ACQBULK", "BREAK", "CALL.ABS"),
}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                   r"([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"(0x[0-9a-f]+|\.L_x_\d+)")


def pipe_of(op: str) -> str:
    """The execution pipe of opcode ``op`` (``IMAD.WIDE.U32`` -> ``fma``)."""
    base = op.split(".")[0]
    if base.startswith("U"):
        return "uniform"
    for pipe, names in PIPES.items():
        if base in names:
            return pipe
    if base.startswith(PIPES["lsu"]):  # LDG, STS, ATOMS, ...
        return "lsu"
    return "other"


def _counts(ops) -> dict:
    by_op, by_pipe = {}, {}
    for op in ops:
        by_op[op] = by_op.get(op, 0) + 1
        p = pipe_of(op)
        by_pipe[p] = by_pipe.get(p, 0) + 1
    return {"n": len(ops), "pipes": dict(sorted(by_pipe.items())),
            "ops": dict(sorted(by_op.items(), key=lambda kv: -kv[1]))}


def functions(text: str) -> dict:
    """{mangled name: [(address, opcode, operands)]} of a cuobjdump
    listing; labels (``.L_x_N``) resolve to the next address."""
    out, cur, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            addr = int(m.group(1), 16)
            for p in pending:
                labels[p] = addr
            pending = []
            cur.append((addr, m.group(2), m.group(3)))
    for name, insns in out.items():
        out[name] = [(a, op, _resolve(rest, labels)) for a, op, rest in insns]
    return out


def _resolve(rest: str, labels: dict):
    m = _TARGET.search(rest)
    if not m:
        return None
    t = m.group(1)
    return int(t, 16) if t.startswith("0x") else labels.get(t)


def loops(insns) -> list:
    """Every backward branch's body (target .. branch), innermost
    first, with its opcode and pipe counts."""
    found = []
    for addr, op, target in insns:
        if op.startswith("BRA") and target is not None and target <= addr:
            body = [o for a, o, _ in insns if target <= a <= addr]
            found.append({"start": hex(target), "end": hex(addr),
                          **_counts(body)})
    return sorted(found, key=lambda lp: lp["n"])


def mix(lib, pattern: str = "") -> dict:
    """{function: {n, pipes, ops, loops}} for the functions of library
    ``lib`` matching ``pattern``; writes the listing beside it
    (``.sass``), or reads ``lib`` as one."""
    if str(lib).endswith(".sass"):
        with open(lib) as f:
            text = f.read()
    else:
        tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
        res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, timeout=300)
        if res.returncode:
            raise RuntimeError(
                f"cuobjdump failed: {res.stderr.strip()[-500:]}")
        text = res.stdout
        with open(f"{os.path.splitext(str(lib))[0]}.sass", "w") as f:
            f.write(text)
    out = {}
    for name, insns in functions(text).items():
        if re.search(pattern, name):
            out[name] = {**_counts([op for _, op, _ in insns]),
                         "loops": loops(insns)}
    return out


def main(argv) -> int:
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(json.dumps(mix(argv[0], argv[1] if len(argv) > 1 else "")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
