"""Kernel B: the quotient fold as one launch per part.

Counterpart of `jax.jit(fold_fn)` at `halo2_tpu/plonk/evaluation.py:412`,
which XLA compiles into one device program per part: every gate, permutation
and lookup constraint of the clusters a part fires, each scaled by its power
of y and summed into its cluster's accumulator. The port records the same
program once per fold, as `jax.jit` traces, and runs it in one launch of
`csrc/fold.cu` (one thread a row) on CUDA tensors.

Recording. `record` runs the evaluator's walk (`plonk/evaluation.py`, the
same walk the eager fold runs on `FVec`s) on `Rec` stand-ins:

- the fold's input columns, the coset points, the challenges, y, beta,
  gamma and theta, and every constant are leaves; a rotation of a column is
  a leaf too (`out[i] = v[(i + r) mod n]`, `torch.roll`'s rule, with n the
  local row count);
- an operation on two row-independent values (`FVec.fill` constants, the
  powers of y, beta * F(delta^j), ...) becomes an entry of the scalar table,
  computed before the launch with the public field ops on (16,) tensors;
- any other `+`, `-`, `*` or unary `-` appends an instruction, its leaf
  operands loaded just before it (`LOAD(slot, array, rotation)`, `SCALAR`,
  `COSET_X`);
- `ACC(cluster, slot)` writes each cluster's sum to its output.

One walk keeps the order of the operations and their operands, and the
kernel's arithmetic is kernel A's, so its limbs equal the eager fold's bit
for bit. Slots come from a linear scan over the instructions once the dead
ones are dropped; `Program.slots` is the most that are live at once.

`run_program_plain` interprets a program with the plain field ops
(`*_plain` of `ops/field.py`); `run_program` launches kernel B for CUDA
tensors and runs the plain version for CPU tensors. `Fold` is the fold the
evaluator calls: kernel B on CUDA tensors, the eager walk on CPU tensors.
No PyTorch call computes the fold ("library: none").
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..fields import FieldElement
from . import _build
from .field import (NLIMBS, FieldCtx, add_mod, add_mod_plain, mont_mul, mont_mul_plain, neg_mod,
                    sub_mod, sub_mod_plain)

# opcodes, in csrc/fold.cu's order
LOAD, SCALAR, COSET_X, ADD, SUB, MUL, NEG, ACC = range(8)
OPCODES = ("LOAD", "SCALAR", "COSET_X", "ADD", "SUB", "MUL", "NEG", "ACC")
# kernel B is built for these slot counts; a program takes the smallest that holds it
SLOT_CLASSES = (8, 16, 32, 64, 128)
LAUNCHES = {"fold_program": 0}

_P = ctypes.c_void_p
_SIG = {"fold_program": (_P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P)}


class Program:
    """A recorded fold: `instrs` (op, dst, a, b) over physical slots;
    `array_ids` the fold's input columns in LOAD's array order; `scalar_defs`
    the scalar table's entries, in order, each ("input", name, index),
    ("const", value) or (op, i, j) on earlier entries; `clusters` the output
    order of ACC's cluster operand; `slots` the most live slots."""

    def __init__(self, field, instrs, array_ids, scalar_defs, clusters, slots):
        self.field = field
        self.instrs: List[Tuple[int, int, int, int]] = instrs
        self.array_ids = tuple(array_ids)
        self.scalar_defs = scalar_defs
        self.clusters = tuple(clusters)
        self.slots = slots
        self._dev: Dict = {}

    def counts(self) -> Dict[str, int]:
        """Instructions of each opcode."""
        out = {name: 0 for name in OPCODES}
        for op, *_ in self.instrs:
            out[OPCODES[op]] += 1
        return out

    def tensor(self, device) -> torch.Tensor:
        """The instructions as an (len, 4) int32 tensor on `device` (cached)."""
        key = ("prog", torch.device(device))
        t = self._dev.get(key)
        if t is None:
            t = torch.tensor(self.instrs, dtype=torch.int32).reshape(-1, 4).to(device)
            self._dev[key] = t
        return t


class Rec:
    """The recording stand-in for `FVec`: a leaf (a column with its
    rotation, the coset points, a scalar-table entry) or a value computed
    by an instruction (a virtual register)."""

    __slots__ = ("rec", "kind", "ref", "rot")

    def __init__(self, rec: "Recorder", kind: str, ref: int, rot: int = 0):
        self.rec, self.kind, self.ref, self.rot = rec, kind, ref, rot

    def rotate(self, r: int) -> "Rec":
        if self.kind != "array":
            raise ValueError("fold recording: only an input column can be rotated")
        return Rec(self.rec, "array", self.ref, self.rot + r)

    def _other(self, other) -> "Rec":
        if isinstance(other, Rec):
            return other
        if isinstance(other, FieldElement):
            return self.rec.const(other.v)
        if isinstance(other, int):
            return self.rec.const(other)
        raise TypeError(f"cannot combine a recorded value with {type(other)}")

    def __add__(self, other):
        return self.rec.binary(ADD, self, self._other(other))

    def __sub__(self, other):
        return self.rec.binary(SUB, self, self._other(other))

    def __mul__(self, other):
        return self.rec.binary(MUL, self, self._other(other))

    def __neg__(self):
        return self.rec.unary_neg(self)


class Recorder:
    """Collects a fold's instructions (over virtual registers) and its
    scalar table while the walk runs on `Rec`s."""

    def __init__(self, field):
        self.field = field
        self.p = field.MODULUS
        self.instrs: List[list] = []
        self.scalar_defs: List[tuple] = []
        self._scalar_index: Dict[tuple, int] = {}
        self.nvreg = 0

    # ---- leaves ----
    def _scalar(self, key: tuple) -> Rec:
        i = self._scalar_index.get(key)
        if i is None:
            i = len(self.scalar_defs)
            self.scalar_defs.append(key)
            self._scalar_index[key] = i
        return Rec(self, "scalar", i)

    def const(self, v: int) -> Rec:
        return self._scalar(("const", v % self.p))

    def input(self, name: str, index: int = -1) -> Rec:
        return self._scalar(("input", name, index))

    def array(self, pos: int) -> Rec:
        return Rec(self, "array", pos)

    def coset_x(self) -> Rec:
        return Rec(self, "coset", 0)

    # ---- instructions ----
    def _emit(self, op: int, a: int, b: int = 0) -> Rec:
        dst = self.nvreg
        self.nvreg += 1
        self.instrs.append([op, dst, a, b])
        return Rec(self, "vreg", dst)

    def vreg(self, x: Rec) -> int:
        """x in a virtual register: a leaf is loaded just before its use."""
        if x.kind == "vreg":
            return x.ref
        if x.kind == "array":
            return self._emit(LOAD, x.ref, x.rot).ref
        if x.kind == "scalar":
            return self._emit(SCALAR, x.ref).ref
        return self._emit(COSET_X, 0).ref

    def binary(self, op: int, a: Rec, b: Rec) -> Rec:
        if a.kind == "scalar" and b.kind == "scalar":
            return self._scalar((op, a.ref, b.ref))
        va, vb = self.vreg(a), self.vreg(b)
        return self._emit(op, va, vb)

    def unary_neg(self, a: Rec) -> Rec:
        if a.kind == "scalar":
            return self._scalar((NEG, a.ref, 0))
        return self._emit(NEG, self.vreg(a))

    # ---- the program ----
    def finish(self, acc: Dict[int, Rec], array_ids: Sequence[int]) -> Program:
        clusters = list(acc)
        for j, c in enumerate(clusters):
            self.instrs.append([ACC, j, self.vreg(acc[c]), 0])
        # drop instructions whose value no ACC needs
        live, kept = set(), []
        for ins in reversed(self.instrs):
            op, dst, a, b = ins
            if op != ACC and dst not in live:
                continue
            kept.append(ins)
            live.update(_operands(op, a, b))
        kept.reverse()
        # linear scan: a slot is free again after the last use of its value;
        # an instruction may write a slot one of its operands frees
        last: Dict[int, int] = {}
        for pc, (op, dst, a, b) in enumerate(kept):
            for v in _operands(op, a, b):
                last[v] = pc
        free: List[int] = []
        slot_of: Dict[int, int] = {}
        nslots = 0
        out = []
        for pc, (op, dst, a, b) in enumerate(kept):
            ops = _operands(op, a, b)
            phys = [slot_of[v] for v in ops]
            for v in set(ops):
                if last[v] == pc:
                    free.append(slot_of.pop(v))
            if op == ACC:
                out.append((ACC, dst, phys[0], 0))
                continue
            if free:
                s = min(free)
                free.remove(s)
            else:
                s = nslots
                nslots += 1
            slot_of[dst] = s
            # LOAD (array, rotation), SCALAR (entry) and COSET_X keep their operands
            out.append((op, s, *(phys + [0])[:2]) if ops else (op, s, a, b))
        return Program(self.field, out, array_ids, list(self.scalar_defs), clusters, nslots)


def _operands(op: int, a: int, b: int) -> Tuple[int, ...]:
    if op in (ADD, SUB, MUL):
        return (a, b)
    if op in (NEG, ACC):
        return (a,)
    return ()


def record(field, walk: Callable, array_ids: Sequence[int], n_challenges: int) -> Program:
    """The program of `walk(vecs, coset_x, scalars, const_vec)`, the
    evaluator's fold walk, over the input columns `array_ids`."""
    rec = Recorder(field)
    vecs = {i: rec.array(pos) for pos, i in enumerate(array_ids)}
    scalars = SimpleNamespace(
        y=rec.input("y"), beta=rec.input("beta"), gamma=rec.input("gamma"),
        theta=rec.input("theta"), ch=[rec.input("ch", i) for i in range(n_challenges)],
        one=rec.const(1))
    acc = walk(vecs, rec.coset_x(), scalars, rec.const)
    return rec.finish(acc, array_ids)


def scalar_table(program: Program, scal: dict, device) -> torch.Tensor:
    """The (S, 16) scalar table of `program` for the scalar inputs `scal`
    ({"y", "beta", "gamma", "theta": (16,), "ch": [(16,), ...]}, Montgomery
    limbs), computed with the public field ops as the eager fold computes
    the same values."""
    ctx = FieldCtx(program.field)
    consts = [d[1] for d in program.scalar_defs if d[0] == "const"]
    const_t = iter(ctx.consts(consts, device)) if consts else iter(())
    ops = {MUL: mont_mul, ADD: add_mod, SUB: sub_mod}
    vals: List[torch.Tensor] = []
    for d in program.scalar_defs:
        if d[0] == "input":
            v = scal[d[1]] if d[2] < 0 else scal[d[1]][d[2]]
        elif d[0] == "const":
            v = next(const_t)
        elif d[0] == NEG:
            v = neg_mod(vals[d[1]], ctx)
        else:
            v = ops[d[0]](vals[d[1]], vals[d[2]], ctx)
        vals.append(v.reshape(NLIMBS))
    return torch.stack(vals).contiguous()


def run_program_plain(program: Program, arrays: Sequence[torch.Tensor], coset_x: torch.Tensor,
                      scalars: torch.Tensor) -> Dict[int, torch.Tensor]:
    """The program on tensors with the plain field ops: {cluster: (n, 16)}."""
    ctx = FieldCtx(program.field)
    n = coset_x.shape[0]
    slots: List = [None] * program.slots
    outs: Dict[int, torch.Tensor] = {}
    plain = {ADD: add_mod_plain, SUB: sub_mod_plain, MUL: mont_mul_plain}
    for op, d, a, b in program.instrs:
        if op == LOAD:
            slots[d] = torch.roll(arrays[a], -b, dims=0)
        elif op == SCALAR:
            slots[d] = scalars[a]
        elif op == COSET_X:
            slots[d] = coset_x
        elif op == NEG:
            slots[d] = sub_mod_plain(torch.zeros_like(slots[a]), slots[a], ctx)
        elif op == ACC:
            outs[program.clusters[d]] = slots[a].expand(n, NLIMBS).contiguous()
        else:
            slots[d] = plain[op](slots[a], slots[b], ctx)
    return outs


def run_program(program: Program, arrays: Sequence[torch.Tensor], coset_x: torch.Tensor,
                scalars: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Kernel B for CUDA tensors, run_program_plain for CPU tensors: the
    program over `arrays` (program.array_ids' columns, each (n, 16)), the
    coset points (n, 16) and the scalar table (S, 16); {cluster: (n, 16)},
    views of one (clusters, n, 16) output."""
    if not _build.on_card(coset_x, "fold_program"):
        return run_program_plain(program, arrays, coset_x, scalars)
    dev = coset_x.device
    n = coset_x.shape[0]
    if len(arrays) != len(program.array_ids):
        raise ValueError(f"fold_program: {len(arrays)} arrays for {len(program.array_ids)} columns")
    _build.check_tensor(coset_x, (n, NLIMBS), "coset_x", dev, align=16)
    _build.check_tensor(scalars, (len(program.scalar_defs), NLIMBS), "scalars", dev, align=16)
    for j, t in enumerate(arrays):
        _build.check_tensor(t, (n, NLIMBS), f"array {j}", dev, align=16)
    slots = next((s for s in SLOT_CLASSES if s >= program.slots), None)
    if slots is None:
        raise ValueError(f"fold_program: {program.slots} live slots, more than {SLOT_CLASSES[-1]}")
    ptrs = tuple(t.data_ptr() for t in arrays) or (0,)
    key = ("ptrs", dev, ptrs)
    table = program._dev.get(key)
    if table is None:  # the pointer table of the last arrays, kept for a repeat
        program._dev = {k: v for k, v in program._dev.items() if k[0] != "ptrs"}
        table = torch.tensor(ptrs, dtype=torch.int64).to(dev)
        program._dev[key] = table
    prog = program.tensor(dev)
    out = torch.empty((len(program.clusters), n, NLIMBS), dtype=torch.int32, device=dev)
    lib = _build.load("fold", _SIG)
    err = lib.fold_program(prog.data_ptr(), prog.shape[0], table.data_ptr(), coset_x.data_ptr(),
                           scalars.data_ptr(), out.data_ptr(), n, slots,
                           ctypes.byref(_build.field_consts(FieldCtx(program.field).p_int)),
                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fold_program")
    LAUNCHES["fold_program"] += 1
    return {c: out[j] for j, c in enumerate(program.clusters)}


class Fold:
    """The evaluator's fold for one set of clusters: `eager(arrays,
    coset_x_vals, scal)` is the walk on FVecs (the line-for-line port of the
    JAX fold); on CUDA tensors a call runs the walk's recorded program
    (recorded at the first such call) in kernel B instead."""

    def __init__(self, field, walk: Callable, eager: Callable, needed_idx: Sequence[int],
                 n_challenges: int):
        self.field = field
        self.walk = walk
        self.eager = eager
        self.needed_idx = tuple(needed_idx)
        self.n_challenges = n_challenges
        self._program = None

    @property
    def program(self) -> Program:
        if self._program is None:
            self._program = record(self.field, self.walk, self.needed_idx, self.n_challenges)
        return self._program

    def __call__(self, arrays: dict, coset_x_vals: torch.Tensor, scal: dict):
        if not _build.on_card(coset_x_vals, "fold"):
            return self.eager(arrays, coset_x_vals, scal)
        prog = self.program
        return run_program(prog, [arrays[i] for i in prog.array_ids], coset_x_vals,
                           scalar_table(prog, scal, coset_x_vals.device))
