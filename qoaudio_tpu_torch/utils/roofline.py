"""The least time a kernel's work could take on the card (its bound).

A kernel's bound is the larger of two times: the bytes its function must
move (each input read once, each output written once) over the card's
memory rate, and the time its arithmetic instructions take to issue.  The
instructions are counted from the kernel's own machine code:
:func:`sass_loop` reads ``cuobjdump -sass`` of the built library, finds
the kernel's hottest loop and counts its arithmetic instructions per
window, split by the pipe each issues to; the caller multiplies by the
windows and threads its inputs need.  Where several builds compute one
function (block sizes, store shapes of the same output), :func:`leanest`
takes the count of the build that needs the least time, so a less
efficient build never gets a looser bound.  :func:`sass_chain` reads the
same loop for what a serial recurrence waits on: the longest chain of
dependent instructions per step.

Rates (NVIDIA's H100 SXM data sheet and Hopper white paper), per SM per
clock, times the SMs and the maximum SM clock the card reports: 3.35 TB/s
of HBM3; 64 lane-operations on the ALU pipe (integer add, logic, shift,
compare, select, move: 16 lanes in each of an SM's four partitions) and 64
on the FMA pipe (``IMAD`` and its ``.MOV``/``.SHL``/``.WIDE`` forms, the
float FMA, add and multiply); and 128 instructions of any kind issued, as
each partition's scheduler issues one warp instruction per clock.  So a
loop pass of ``a`` ALU and ``f`` FMA operations among ``i`` instructions
(loads, stores, branches and uniform ones included) takes at least
max(a, f, i / 2) / 64 SM-clocks per thread.
"""

from __future__ import annotations

import dataclasses
import re
import shutil
import subprocess
from typing import Iterable, Optional

import torch

HBM_BYTES_PER_S = 3.35e12
PIPE_OPS_PER_SM_PER_CLOCK = 64  # the ALU pipe's rate, and the FMA pipe's
ISSUE_OPS_PER_SM_PER_CLOCK = 128  # four warp instructions per SM per clock

# opcodes that move data or steer control; every other instruction counts
# as an operation (uniform-datapath U* instructions run once per warp and
# are not counted either)
_NOT_OPS = re.compile(
    r"^(LD|ST|LDG|STG|LDS|STS|LDL|STL|LDC|ATOM|RED|BRA|BRX|JMP|EXIT|RET|CALL|"
    r"BSSY|BSYNC|BAR|WARPSYNC|NOP|YIELD|DEPBAR|MEMBAR|ERRBAR|CCTL)(\.|$)|^U"
)
# operations that issue to the FMA pipe; every other operation counts on
# the ALU pipe
_FMA_PIPE = re.compile(r"^(IMAD|IMUL|IDP|FFMA|FADD|FMUL|HFMA2|HADD2|HMUL2)(\.|$)")
_INSTR = re.compile(  # address, predicate guard, opcode, operands
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);"
)


@dataclasses.dataclass(frozen=True)
class Card:
    name: str
    sms: int
    clock_mhz: float  # maximum SM clock

    @property
    def pipe_ops_per_s(self) -> float:
        """Lane-operations per second on one pipe (ALU or FMA)."""
        return self.sms * PIPE_OPS_PER_SM_PER_CLOCK * self.clock_mhz * 1e6

    @property
    def issue_ops_per_s(self) -> float:
        return self.sms * ISSUE_OPS_PER_SM_PER_CLOCK * self.clock_mhz * 1e6


def card(device) -> Card:
    """The CUDA ``device``'s SM count (torch) and maximum SM clock
    (``nvidia-smi``)."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    r = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return Card(props.name, props.multi_processor_count, float(r.stdout.split()[0]))


def ops_ms(alu: float, fma: float, issued: float, card: Card) -> float:
    """Least ms for ``alu`` ALU-pipe and ``fma`` FMA-pipe operations among
    ``issued`` instructions: each pipe at its own rate, every instruction
    at the issue rate."""
    return max(alu / card.pipe_ops_per_s, fma / card.pipe_ops_per_s,
               issued / card.issue_ops_per_s) * 1e3


def bound_ms(n_bytes: float, alu: float, fma: float, issued: float,
             card: Card) -> tuple[float, str]:
    """(least ms, "bytes" or "operations": which of the two binds)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(alu, fma, issued, card)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def leanest(counts: Iterable[dict]) -> dict:
    """Of several builds' :func:`sass_loop` counts for one function, the
    one whose loop needs the least time per window."""
    return min(counts, key=lambda c: max(c["alu_per_window"], c["fma_per_window"],
                                         c["instructions_per_window"] / 2))


def find_cuobjdump(nvcc: Optional[str]) -> Optional[str]:
    """``cuobjdump`` beside ``nvcc``, else on PATH."""
    if nvcc:
        cand = nvcc[: -len("nvcc")] + "cuobjdump"
        if shutil.which(cand):
            return cand
    return shutil.which("cuobjdump")


def sass_functions(lib_path: str, cuobjdump: str) -> dict:
    """Mangled kernel name -> its SASS text, from ``cuobjdump -sass``."""
    r = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                       text=True, timeout=300, check=True)
    funcs, name = {}, None
    for line in r.stdout.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def _branch_target(op: str, args: str) -> Optional[int]:
    if not op.startswith("BRA"):
        return None
    m = re.search(r"0x([0-9a-f]+)", args)
    return int(m.group(1), 16) if m else None


def _hottest_loop(instrs) -> tuple[int, int]:
    """(first, last address) of the largest innermost loop: a backward
    branch whose range holds no other backward branch."""
    loops = []
    for addr, op, args in instrs:
        t = _branch_target(op, args)
        if t is not None and t <= addr:
            loops.append((t, addr))
    inner = [(a, b) for a, b in loops
             if not any((c, d) != (a, b) and a <= c and d <= b for c, d in loops)]
    if not inner:
        raise ValueError("no loop found in the kernel's SASS")
    return max(inner, key=lambda ab: ab[1] - ab[0])


def _window_count(body, window_load: str, loads_per_window: int) -> int:
    loads = sum(1 for op in body if re.match(window_load, op))
    if loads == 0 or loads % loads_per_window:
        raise ValueError(f"{loads} window loads in the loop, not a multiple of "
                         f"{loads_per_window}")
    return loads // loads_per_window


def sass_loop(sass: str, window_load: str, loads_per_window: int) -> dict:
    """Count one kernel's hottest loop.

    The loop is the largest innermost one: a backward branch whose range
    holds no other backward branch.  ``window_load`` is a regex of the
    load opcode each window makes ``loads_per_window`` of (it tells how
    many windows one pass of the loop runs, should the compiler unroll
    it).  Returns the loop's instructions, operations (see ``_NOT_OPS``)
    and windows per pass, and per window the instructions, the operations
    and their split into the ALU and the FMA pipe (see ``_FMA_PIPE``).
    """
    instrs = [(int(a, 16), op, args) for a, _, op, args in _INSTR.findall(sass)]
    a, b = _hottest_loop(instrs)
    body = [op for addr, op, _ in instrs if a <= addr <= b]
    ops = [op for op in body if not _NOT_OPS.search(op)]
    fma = sum(1 for op in ops if _FMA_PIPE.search(op))
    windows = _window_count(body, window_load, loads_per_window)
    return {"instructions": len(body), "ops": len(ops), "windows_per_pass": windows,
            "ops_per_window": len(ops) / windows,
            "alu_per_window": (len(ops) - fma) / windows,
            "fma_per_window": fma / windows,
            "instructions_per_window": len(body) / windows}


# -- the dependent path ------------------------------------------------------

_REG = re.compile(r"(?<![A-Z0-9_])(UR|R|UP|P)(\d+)(\.64|\.128)?")
_NO_DEST = re.compile(
    r"^(ST|STG|STS|STL|RED|BRA|BRX|JMP|EXIT|RET|CALL|BSSY|BSYNC|BAR|WARPSYNC|NOP|"
    r"YIELD|DEPBAR|MEMBAR|ERRBAR|CCTL)(\.|$)"
)
_ENDS_BLOCK = re.compile(r"^(BRA|BRX|JMP|EXIT|RET|CALL)(\.|$)")
_SETS_PREDICATES = re.compile(r"^(ISETP|FSETP|DSETP|HSETP2|PSETP|PLOP3)(\.|$)")
_TWO_DESTS = re.compile(r"^(SHFL|VOTE)(\.|$)")
_CARRY_OUT = re.compile(r"^(IADD3|LEA|IMAD)(\.|$)")
_PREDICATE = re.compile(r"^U?P(\d|T)$")


def _regs(token: str, width: int = 1) -> list:
    """Registers named in one operand: a ``.64``/``.128`` suffix (or
    ``width``) spans consecutive registers; RZ, PT and constants name none."""
    out = []
    for kind, num, suffix in _REG.findall(token):
        n = 1 if kind.endswith("P") else max(width, {".64": 2, ".128": 4}.get(suffix, 1))
        out += [f"{kind}{int(num) + j}" for j in range(n)]
    return out


def _dests_and_sources(guard: str, op: str, args: str) -> tuple[list, list]:
    operands = [t.strip() for t in args.split(",") if t.strip()]
    if _NO_DEST.search(op):
        n_dest = 0
    elif _SETS_PREDICATES.search(op):
        n_dest = 0
        while n_dest < len(operands) and _PREDICATE.match(operands[n_dest]):
            n_dest += 1
    elif _TWO_DESTS.search(op):
        n_dest = 2
    else:
        n_dest = 1
        if _CARRY_OUT.search(op):  # carry-out predicates follow the result
            while n_dest < len(operands) and _PREDICATE.match(operands[n_dest]):
                n_dest += 1
    width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
    dests = _regs(operands[0], width) if n_dest else []
    for t in operands[1:n_dest]:
        dests += _regs(t)
    srcs = []
    for i, t in enumerate(operands[n_dest:]):
        wide_addend = ".WIDE" in op and i == 2  # IMAD.WIDE's 64-bit addend
        srcs += _regs(t, 2 if wide_addend else 1)
    if guard:  # a predicated write keeps the old value where it is off
        srcs += _regs(guard) + dests
    return dests, srcs


def sass_chain(sass: str, window_load: str, loads_per_window: int,
               steps_per_window: int) -> dict:
    """The longest chain of dependent instructions in one kernel's hottest
    loop (see :func:`sass_loop`), per step of its serial recurrence.

    The chain is taken over the loop's largest straight-line block (no
    branch in it, none into it): there the compiler has laid out a whole
    window's unrolled steps, one after the other.  Each instruction waits
    for the last writer of every register or predicate it reads (and, when
    predicated, of the one it writes); the chain is the deepest such
    wait, in instructions.  Divided by the steps the block runs
    (``steps_per_window`` x the windows of one loop pass), it is the
    dependent path one step adds: the instructions whose latencies the
    recurrence pays one after the other, which no other warp hides when
    the warp sits alone on its scheduler."""
    instrs = [(int(a, 16), g.strip(), op, args) for a, g, op, args in _INSTR.findall(sass)]
    a, b = _hottest_loop([(addr, op, args) for addr, _, op, args in instrs])
    body = [i for i in instrs if a <= i[0] <= b]
    windows = _window_count([op for _, _, op, _ in body], window_load, loads_per_window)
    targets = {t for addr, _, op, args in instrs
               if (t := _branch_target(op, args)) is not None}
    blocks, cur = [], []
    for ins in body:
        if ins[0] in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append(ins)
        if _ENDS_BLOCK.search(ins[2]):
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    block = max(blocks, key=len)
    depth, chain = {}, 0
    for _, guard, op, args in block:
        dests, srcs = _dests_and_sources(guard, op, args)
        d = 1 + max((depth.get(r, 0) for r in srcs), default=0)
        for r in dests:
            depth[r] = d
        chain = max(chain, d)
    steps = steps_per_window * windows
    return {"block_instructions": len(block), "chain": chain, "steps": steps,
            "chain_per_step": chain / steps}
