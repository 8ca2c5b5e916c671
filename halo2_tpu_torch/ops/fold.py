"""Kernel B: the quotient fold as one launch per part.

Counterpart of `jax.jit(fold_fn)` at `halo2_tpu/plonk/evaluation.py:412`,
which XLA compiles into one device program per part: every gate, permutation
and lookup constraint of the clusters a part fires, each scaled by its power
of y and summed into its cluster's accumulator. The port records the same
program once per fold, as `jax.jit` traces, and runs it in one launch of
`csrc/fold.cu` on CUDA tensors: each instruction of a bundle on its own warp
of a block, over the block's 32 rows.

Recording. `record` runs the evaluator's walk (`plonk/evaluation.py`, the
same walk the eager fold runs on `FVec`s) on `Rec` stand-ins:

- the fold's input columns, the coset points, the challenges, y, beta,
  gamma and theta, and every constant are leaves; a rotation of a column is
  a leaf too (`out[i] = v[(i + r) mod n]`, `torch.roll`'s rule, with n the
  local row count);
- an operation on two row-independent values (`FVec.fill` constants, the
  powers of y, beta * F(delta^j), ...) becomes an entry of the scalar table;
- any other `+`, `-`, `*` or unary `-` appends an instruction, its leaf
  operands each recorded just before it (`LOAD(vreg, array, rotation)`,
  `SCALAR(vreg, entry)`, `COSET_X(vreg)`);
- `ACC(cluster, value)` writes each cluster's sum to its output.

The program. The instructions no ACC needs are dropped. A leaf takes no
instruction of its own in kernel B: each instruction that uses it reads it
where it lies (operand mode COLUMN, ENTRY or COSET; a computed value is a
SLOT). The other instructions are list-scheduled (`schedule`) into bundles
of up to `BUNDLE_WIDTH` instructions of one opcode, none depending on
another of its bundle, the longest chain of work first within a lookahead
of `WINDOW` recorded instructions, the ACCs in their order. Slots are then
allocated over the bundles (`allocate`): a slot is free again after the
bundle of its value's last use, and only the instruction that frees it may
write it in that bundle, so no instruction reads or writes a slot that
another of its bundle writes. `Program.slots` is the most that are live at
once. One walk keeps each
operation's operands, and reordering operations that do not depend on each
other changes no value, so with kernel A's arithmetic kernel B's limbs
equal the eager fold's bit for bit.

The scalar table. `scalar_program` records the table's definitions as a
program over one row: y, beta, gamma, theta and the challenges are columns
of one row (the rows of the (4 + challenges, 16) tensor the evaluator
makes), the constants entries of its own table, entry j the output j. On
CUDA tensors `scalar_table` is one launch of kernel B; on CPU tensors it
computes the entries with the public field ops on (16,) tensors, as the
eager fold computes the same values.

`run_program_plain` interprets a program with the plain field ops
(`*_plain` of `ops/field.py`), instruction by instruction in bundle order;
`run_program` launches kernel B for CUDA tensors and runs the plain version
for CPU tensors. `launch_geometry` is the launch's shape, kept in Python so
that the CPU tests reach it. `Fold` is the fold the evaluator calls: kernel
B on CUDA tensors, the eager walk on CPU tensors. No PyTorch call computes
the fold ("library: none").
"""

from __future__ import annotations

import ctypes
import heapq
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..fields import FieldElement
from . import _build
from .field import (NLIMBS, FieldCtx, add_mod, add_mod_plain, mont_mul, mont_mul_plain, neg_mod,
                    sub_mod, sub_mod_plain)

# the recording's opcodes; csrc/fold.cu numbers ADD to ACC the same
LOAD, SCALAR, COSET_X, ADD, SUB, MUL, NEG, ACC = range(8)
OPCODES = ("LOAD", "SCALAR", "COSET_X", "ADD", "SUB", "MUL", "NEG", "ACC")
LEAVES = (LOAD, SCALAR, COSET_X)
# kernel B's operand modes (csrc/fold.cu Mode): a slot, or the leaf it reads
SLOT, COLUMN, ENTRY, COSET = range(4)
MODE_OF = {LOAD: COLUMN, SCALAR: ENTRY, COSET_X: COSET}
# instructions a bundle; csrc/fold.cu's FOLD_WIDTH default (the library
# built for another width is a variant of its own)
BUNDLE_WIDTH = 4
# the scheduler's weights of an instruction on the chain it ends
LATENCY = {ADD: 2, SUB: 2, MUL: 8, NEG: 2, ACC: 1}
# instructions (leaves not counted) of the recording order the scheduler looks ahead over
WINDOW = 128
# the instruction that fills a bundle to the width (csrc/fold.cu kPad)
PAD = -1
# a program's live slots take the smallest class that holds them
SLOT_CLASSES = (8, 16, 32, 64, 128)
ROWS_PER_BLOCK = 32  # a block: BUNDLE_WIDTH warps over 32 rows, one a lane
RECORD_BYTES = 32  # an instruction of kernel B: two records of four int32
MAX_SHARED = 232448  # bytes of shared memory a block may take on an H100 (227 KB)
MAX_ARRAYS = 448  # column pointers in the launch's parameters (csrc/fold.cu kMaxArrays)
LAUNCHES = {"fold_program": 0}

_P = ctypes.c_void_p
_SIG = {"fold_program": (_P, ctypes.c_int, _P), "fold_width": (),
        "fold_params_size": ()}


class FoldParams(ctypes.Structure):
    """Host mirror of `FoldParams` in csrc/fold.cu (the launch's parameters)."""

    _fields_ = [
        ("prog", _P), ("coset_x", _P), ("scalars", _P), ("out", _P),
        ("n", ctypes.c_longlong), ("bundles", ctypes.c_int),
        ("k", _build.FieldConsts), ("arrays", _P * MAX_ARRAYS),
    ]


def _operands(op: int, a: int, b: int) -> Tuple[int, ...]:
    if op in (ADD, SUB, MUL):
        return (a, b)
    if op in (NEG, ACC):
        return (a,)
    return ()


def schedule(vinstrs: Sequence[Sequence[int]], width: int) -> List[List[int]]:
    """List-schedule the instructions of `vinstrs` ((op, dst, a, b) over
    virtual registers in recording order, each defined once before its uses;
    an ACC's dst is its output) that are not leaves into bundles: lists of
    indices of up to `width` instructions of one opcode whose operands are
    leaves or defined in earlier bundles. Only the WINDOW such instructions
    from the first one not yet scheduled are candidates, which
    bounds how far the schedule spreads the recording's live ranges. Each
    bundle takes the opcode of the candidate with the longest chain after it
    (LATENCY summed) and the candidates of that opcode in that order; the
    ACCs keep their order."""
    comp = [i for i, ins in enumerate(vinstrs) if ins[0] not in LEAVES]
    n = len(comp)
    pos = {i: k for k, i in enumerate(comp)}
    defs = {vinstrs[i][1]: pos[i] for i in comp if vinstrs[i][0] != ACC}
    ops = [vinstrs[i][0] for i in comp]
    preds = [{defs[v] for v in _operands(op, a, b) if v in defs}
             for op, _, a, b in (vinstrs[i] for i in comp)]
    succs: List[List[int]] = [[] for _ in range(n)]
    for k, ps in enumerate(preds):
        for j in ps:
            succs[j].append(k)
    height = [0] * n
    for k in reversed(range(n)):
        height[k] = LATENCY[ops[k]] + max((height[s] for s in succs[k]), default=0)
    waiting = [len(ps) for ps in preds]
    ready = {k for k in range(n) if not waiting[k] and ops[k] != ACC}
    accs = [k for k in range(n) if ops[k] == ACC]
    done = [False] * n
    head, next_acc, bundles = 0, 0, []
    while head < n:
        # the ACCs whose values are ready, in order from the first not yet written
        acc_cands = []
        while (next_acc + len(acc_cands) < len(accs) and len(acc_cands) < width
               and not waiting[accs[next_acc + len(acc_cands)]]
               and accs[next_acc + len(acc_cands)] < head + WINDOW):
            acc_cands.append(accs[next_acc + len(acc_cands)])
        cands = [k for k in ready if k < head + WINDOW] + acc_cands
        best = max(cands, key=lambda k: (height[k], -k))
        if ops[best] == ACC:
            members = acc_cands
            next_acc += len(members)
        else:
            members = sorted((k for k in cands if ops[k] == ops[best]),
                             key=lambda k: (-height[k], k))[:width]
            members.sort()
            ready.difference_update(members)
        bundles.append([comp[k] for k in members])
        for k in members:
            done[k] = True
            for s in succs[k]:
                waiting[s] -= 1
                if not waiting[s] and ops[s] != ACC:
                    ready.add(s)
        while head < n and done[head]:
            head += 1
    return bundles


def allocate(vinstrs: Sequence[Sequence[int]], bundles: Sequence[Sequence[int]]):
    """(instructions in bundle order, slots used). An instruction is (op,
    dst, a, b, a's mode, a's rotation, b's mode, b's rotation): dst a slot
    (an ACC's: its output), an operand a slot (SLOT) or the leaf it reads
    (COLUMN: the array and its rotation, ENTRY: the scalar entry, COSET).
    A value's slot is free again after the bundle of its last use; within
    that bundle only an instruction that reads it alone may write it (its
    own operand, read before the write), so no instruction of a bundle reads
    or writes a slot that another instruction of the bundle writes."""
    leaf = {dst: (MODE_OF[op], a, b) for op, dst, a, b in vinstrs if op in LEAVES}
    last: Dict[int, int] = {}
    for bi, members in enumerate(bundles):
        for i in members:
            op, _, a, b = vinstrs[i]
            for v in _operands(op, a, b):
                if v not in leaf:
                    last[v] = bi
    free: List[int] = []
    slot_of: Dict[int, int] = {}
    nslots = 0
    out = []
    for bi, members in enumerate(bundles):
        readers: Dict[int, int] = {}
        for i in members:
            op, _, a, b = vinstrs[i]
            for v in set(_operands(op, a, b)):
                if v not in leaf:
                    readers[v] = readers.get(v, 0) + 1
        dying = {v for v in readers if last[v] == bi}
        fields = []
        for i in members:
            op, _, a, b = vinstrs[i]
            f = []
            for v in _operands(op, a, b):
                f += [leaf[v][1], leaf[v][0], leaf[v][2]] if v in leaf else [slot_of[v], SLOT, 0]
            fields.append((f + [0, SLOT, 0] * 2)[:6])
        released = {v: slot_of.pop(v) for v in dying}
        taken = set()
        for i, (a, am, ar, b, bm, br) in zip(members, fields):
            op, dst, va, vb = vinstrs[i]
            if op != ACC:
                own = sorted(released[v] for v in set(_operands(op, va, vb))
                             if v in dying and readers[v] == 1)
                if own:
                    dst = own[0]
                    taken.add(dst)
                elif free:
                    dst = heapq.heappop(free)
                else:
                    dst = nslots
                    nslots += 1
                slot_of[vinstrs[i][1]] = dst
            out.append((op, dst, a, b, am, ar, bm, br))
        for s in released.values():
            if s not in taken:
                heapq.heappush(free, s)
    return out, nslots


def slot_class(slots: int) -> int:
    """The smallest of SLOT_CLASSES that holds `slots` slots."""
    cls = next((c for c in SLOT_CLASSES if c >= slots), None)
    if cls is None:
        raise ValueError(f"fold_program: {slots} live slots, more than {SLOT_CLASSES[-1]}")
    return cls


def launch_geometry(slots: int, n: int, width: int = BUNDLE_WIDTH) -> Tuple[int, int, int]:
    """(threads a block, shared bytes a block, blocks) of kernel B for a
    program of `slots` slots and bundles of `width` over n rows: `width`
    warps over ROWS_PER_BLOCK rows, each slot 32 bytes a row."""
    slot_class(slots)
    shared = slots * 32 * ROWS_PER_BLOCK
    if shared > MAX_SHARED:
        raise ValueError(f"fold_program: {shared} bytes of shared memory a block")
    return 32 * width, shared, -(-n // ROWS_PER_BLOCK)


class Program:
    """A recorded fold: `vinstrs` the kept instructions over virtual
    registers in recording order, leaves included; `instrs` kernel B's
    instructions (allocate's form) in bundle order and `bundle_sizes` the
    instructions of each bundle (at most `width`); `order` the index in
    `vinstrs` of each of `instrs`; `array_ids` the fold's input columns in
    LOAD's array order; `scalar_defs` the scalar table's entries, in order,
    each ("input", name, index), ("const", value) or (op, i, j) on earlier
    entries; `clusters` the output order of ACC's cluster operand; `slots`
    the most live slots."""

    def __init__(self, field, vinstrs, array_ids, scalar_defs, clusters, width: int = BUNDLE_WIDTH):
        self.field = field
        self.vinstrs = [tuple(ins) for ins in vinstrs]
        self.array_ids = tuple(array_ids)
        self.scalar_defs = scalar_defs
        self.clusters = tuple(clusters)
        self.width = width
        bundles = schedule(self.vinstrs, width)
        self.instrs, self.slots = allocate(self.vinstrs, bundles)
        self.order = [i for b in bundles for i in b]
        self.bundle_sizes = [len(b) for b in bundles]
        self._dev: Dict = {}
        self._scalar_program: Optional["Program"] = None

    def with_width(self, width: int) -> "Program":
        """The same instructions scheduled into bundles of `width`."""
        return Program(self.field, self.vinstrs, self.array_ids, self.scalar_defs, self.clusters,
                       width)

    def bundles(self) -> List[List[Tuple[int, ...]]]:
        out, pc = [], 0
        for size in self.bundle_sizes:
            out.append(self.instrs[pc:pc + size])
            pc += size
        return out

    def counts(self) -> Dict[str, int]:
        """Recorded instructions of each opcode (the leaves included)."""
        out = {name: 0 for name in OPCODES}
        for op, *_ in self.vinstrs:
            out[OPCODES[op]] += 1
        return out

    def columns_read(self) -> set:
        """The input columns (array positions) the program reads."""
        return {v for ins in self.instrs for v, mode in ((ins[2], ins[4]), (ins[3], ins[6]))
                if mode == COLUMN}

    def encode(self, n: int) -> List[Tuple[int, ...]]:
        """Kernel B's instruction stream over n rows: each instruction two
        records (op, dst, a, b), (a's mode, a's rotation, b's mode, b's
        rotation), each bundle filled to `width` with PAD, each rotation
        reduced to [0, n)."""
        out = []
        for bundle in self.bundles():
            for op, d, a, b, am, ar, bm, br in bundle:
                out.append((op, d, a, b, am, ar % n if am == COLUMN else ar,
                            bm, br % n if bm == COLUMN else br))
            out += [(PAD, 0, 0, 0, SLOT, 0, SLOT, 0)] * (self.width - len(bundle))
        return out

    def tensor(self, device, n: int) -> torch.Tensor:
        """encode(n) as a (2 * bundles * width, 4) int32 tensor on `device` (cached)."""
        key = ("prog", torch.device(device), n)
        t = self._dev.get(key)
        if t is None:
            t = torch.tensor(self.encode(n), dtype=torch.int32).reshape(-1, 4).to(device)
            self._dev[key] = t
        return t

    def consts(self, device) -> torch.Tensor:
        """A scalar program's table (its constants, Montgomery limbs) on `device` (cached)."""
        key = ("consts", torch.device(device))
        t = self._dev.get(key)
        if t is None:
            vals = [d[1] for d in self.scalar_defs]
            t = (FieldCtx(self.field).consts(vals, device) if vals
                 else torch.zeros((0, NLIMBS), dtype=torch.int32, device=device))
            self._dev[key] = t
        return t

    @property
    def scalar_program(self) -> "Program":
        if self._scalar_program is None:
            self._scalar_program = scalar_program(self)
        return self._scalar_program


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
        """x in a virtual register: a leaf is recorded just before its use."""
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
        return Program(self.field, kept, array_ids, list(self.scalar_defs), clusters)


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


def scalar_program(program: Program) -> Program:
    """`program`'s scalar table as a program over one row: each input entry
    a column of its own one-row array (`array_ids` holds the ("input", name,
    index) definitions in the order of those arrays), each constant an entry
    of the scalar program's own table (`scalar_defs` holds them as
    ("const", value)), each operation on earlier entries an instruction,
    and entry j written to output j."""
    vinstrs, vreg, inputs, consts = [], [], [], []
    for j, d in enumerate(program.scalar_defs):
        v = len(vreg)
        if d[0] == "input":
            vinstrs.append((LOAD, v, len(inputs), 0))
            inputs.append(d)
        elif d[0] == "const":
            vinstrs.append((SCALAR, v, len(consts), 0))
            consts.append(d)
        elif d[0] == NEG:
            vinstrs.append((NEG, v, vreg[d[1]], 0))
        else:
            vinstrs.append((d[0], v, vreg[d[1]], vreg[d[2]]))
        vreg.append(v)
        vinstrs.append((ACC, j, v, 0))
    return Program(program.field, vinstrs, inputs, consts, range(len(program.scalar_defs)),
                   program.width)


def scalar_table(program: Program, scal: dict, device) -> torch.Tensor:
    """The (S, 16) scalar table of `program` for the scalar inputs `scal`
    ({"y", "beta", "gamma", "theta": (16,), "ch": [(16,), ...]}, Montgomery
    limbs) on `device`: on the card one launch of kernel B over one row
    (`Program.scalar_program`); on the CPU the public field ops, as the
    eager fold computes the same values."""
    if _build.on_card(scal["y"], "scalar_table"):
        sp = program.scalar_program
        arrays = [(scal[name] if index < 0 else scal[name][index]).reshape(1, NLIMBS)
                  for _, name, index in sp.array_ids]
        return _launch(sp, arrays, None, sp.consts(scal["y"].device), 1).reshape(-1, NLIMBS)
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


def run_program_plain(program: Program, arrays: Sequence[torch.Tensor],
                      coset_x: Optional[torch.Tensor], scalars: torch.Tensor) -> Dict[int, torch.Tensor]:
    """The program on tensors with the plain field ops, instruction by
    instruction in bundle order: {cluster: (n, 16)} (n the rows of coset_x,
    or of the arrays where the program reads no coset points)."""
    ctx = FieldCtx(program.field)
    n = (coset_x if coset_x is not None else arrays[0]).shape[0]
    slots: List = [None] * program.slots
    outs: Dict[int, torch.Tensor] = {}
    plain = {ADD: add_mod_plain, SUB: sub_mod_plain, MUL: mont_mul_plain}

    def operand(v, mode, rot):
        if mode == SLOT:
            return slots[v]
        if mode == COLUMN:
            return torch.roll(arrays[v], -rot, dims=0)
        return scalars[v] if mode == ENTRY else coset_x

    for op, d, a, b, am, ar, bm, br in program.instrs:
        x = operand(a, am, ar)
        if op == NEG:
            slots[d] = sub_mod_plain(torch.zeros_like(x), x, ctx)
        elif op == ACC:
            outs[program.clusters[d]] = x.expand(n, NLIMBS).contiguous()
        else:
            slots[d] = plain[op](x, operand(b, bm, br), ctx)
    return outs


_checked: Dict[int, ctypes.CDLL] = {}


def library(width: int = BUNDLE_WIDTH) -> ctypes.CDLL:
    """Kernel B's library for bundles of `width` (the default build, or the
    variant built with FOLD_WIDTH=width), checked to be that width and to
    share FoldParams' layout."""
    lib = _checked.get(width)
    if lib is None:
        defines = () if width == BUNDLE_WIDTH else (f"FOLD_WIDTH={width}",)
        lib = _build.load("fold", _SIG, defines)
        if lib.fold_width() != width or lib.fold_params_size() != ctypes.sizeof(FoldParams):
            raise RuntimeError(f"fold_program: the library has width {lib.fold_width()} and a "
                               f"{lib.fold_params_size()}-byte FoldParams, expected {width} and "
                               f"{ctypes.sizeof(FoldParams)}")
        _checked[width] = lib
    return lib


def _launch(program: Program, arrays: Sequence[torch.Tensor], coset_x: Optional[torch.Tensor],
            scalars: torch.Tensor, n: int) -> torch.Tensor:
    """One launch of kernel B: the (clusters, n, 16) output."""
    dev = arrays[0].device if coset_x is None else coset_x.device
    if len(arrays) != len(program.array_ids):
        raise ValueError(f"fold_program: {len(arrays)} arrays for {len(program.array_ids)} columns")
    if len(arrays) > MAX_ARRAYS:
        raise ValueError(f"fold_program: {len(arrays)} columns, more than {MAX_ARRAYS}")
    if coset_x is not None:
        _build.check_tensor(coset_x, (n, NLIMBS), "coset_x", dev, align=16)
    _build.check_tensor(scalars, (scalars.shape[0], NLIMBS), "scalars", dev, align=16)
    for j, t in enumerate(arrays):
        _build.check_tensor(t, (n, NLIMBS), f"array {j}", dev, align=16)
    _, shared, _ = launch_geometry(program.slots, n, program.width)
    prog = program.tensor(dev, n)
    out = torch.empty((len(program.clusters), n, NLIMBS), dtype=torch.int32, device=dev)
    params = FoldParams(prog=prog.data_ptr(), coset_x=0 if coset_x is None else coset_x.data_ptr(),
                        scalars=scalars.data_ptr(), out=out.data_ptr(), n=n,
                        bundles=len(program.bundle_sizes),
                        k=_build.field_consts(FieldCtx(program.field).p_int))
    for j, t in enumerate(arrays):
        params.arrays[j] = t.data_ptr()
    err = library(program.width).fold_program(ctypes.byref(params), shared,
                                               torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fold_program")
    LAUNCHES["fold_program"] += 1
    return out


def run_program(program: Program, arrays: Sequence[torch.Tensor], coset_x: torch.Tensor,
                scalars: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Kernel B for CUDA tensors, run_program_plain for CPU tensors: the
    program over `arrays` (program.array_ids' columns, each (n, 16)), the
    coset points (n, 16) and the scalar table (S, 16); {cluster: (n, 16)},
    views of one (clusters, n, 16) output."""
    if not _build.on_card(coset_x, "fold_program"):
        return run_program_plain(program, arrays, coset_x, scalars)
    _build.check_tensor(scalars, (len(program.scalar_defs), NLIMBS), "scalars", coset_x.device,
                        align=16)
    out = _launch(program, arrays, coset_x, scalars, coset_x.shape[0])
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
