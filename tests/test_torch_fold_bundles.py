"""Kernel B's bundles (ops/fold.py): the scheduler's and the slot
allocator's invariants, the one-row scalar program against `scalar_table`,
the launch's geometry and its instruction stream, on the CPU, on every
part's program of the circuits of tests/test_torch_fold_program.py at both
engines' rotations. On the card (`gpu`) the scalar table is one launch of
kernel B and equals the plain one, and kernel B at every bundle width equals
`run_program_plain`.
"""

import ctypes

import pytest
import torch

from halo2_tpu_torch import circuits
from halo2_tpu_torch.ops import fold as fold_ops
from halo2_tpu_torch.ops import field_ew
from test_torch_fold_program import CIRCUITS, fold_inputs, fold_machinery

torch.set_num_threads(1)

WIDTHS = (2, fold_ops.BUNDLE_WIDTH, 8)
ACC, LEAVES = fold_ops.ACC, fold_ops.LEAVES
_PROGRAMS = {}


def programs(name):
    """Every part's fold of `name` (a key of CIRCUITS, or "sha": ShaCircuit's
    part 0) under the part-wise and the row-sharded engine."""
    if name not in _PROGRAMS:
        folds = []
        if name == "sha":
            mach, _, _ = fold_machinery(circuits.ShaCircuit(None, 1), 17, synthesize=False)
            folds.append(mach.fold_for(0)[0])
        else:
            circuit, k, proofs = CIRCUITS[name]
            for mesh in (False, True):
                mach, _, L = fold_machinery(circuit, k, proofs, mesh=mesh)
                folds += [mach.fold_for(c_lo)[0] for c_lo in range(L + 1)]
        _PROGRAMS[name] = folds
    return _PROGRAMS[name]


def operands(op, a, b):
    return fold_ops._operands(op, a, b)


def check_bundles(prog):
    """The scheduler's and the allocator's invariants on one program."""
    W, vin = prog.width, prog.vinstrs
    leaves = {ins[1]: (fold_ops.MODE_OF[ins[0]], ins[2], ins[3]) for ins in vin if ins[0] in LEAVES}
    # every recorded instruction appears once: each one that is no leaf as
    # an instruction, each leaf in the operands of the instructions that use it
    comp = [i for i, ins in enumerate(vin) if ins[0] not in LEAVES]
    assert sorted(prog.order) == comp and len(prog.instrs) == len(comp) == sum(prog.bundle_sizes)
    uses = {v: 0 for v in leaves}
    defined = set()  # virtual registers written by earlier bundles
    content = {}  # slot -> the virtual register it holds, bundle by bundle as the kernel runs
    pc = 0
    for size in prog.bundle_sizes:
        idx, phys = prog.order[pc:pc + size], prog.instrs[pc:pc + size]
        # one opcode, at most W operations
        assert 1 <= size <= W and len({vin[i][0] for i in idx}) == 1
        # none depends on another of its bundle
        for i in idx:
            assert {v for v in operands(vin[i][0], *vin[i][2:]) if v not in leaves} <= defined
        # no slot read or written by two operations of the bundle where one writes it
        writes = [ins[1] for ins in phys if ins[0] != ACC]
        assert len(set(writes)) == len(writes)
        for ins in phys:
            unary = ins[0] in (fold_ops.NEG, ACC)
            reads = {v for v, mode in ((ins[2], ins[4]), (ins[3], ins[6]))[:1 if unary else 2]
                     if mode == fold_ops.SLOT}
            assert not reads & (set(writes) - ({ins[1]} if ins[0] != ACC else set()))
        # each operand reads what the recording names: a leaf where it lies,
        # a value from the slot that holds it (every read, then every write)
        for i, ins in zip(idx, phys):
            op, d, a, b, am, ar, bm, br = ins
            vop, vdst, va, vb = vin[i]
            assert op == vop
            got = [(a, am, ar), (b, bm, br)][:len(operands(vop, va, vb))]
            for v, (x, mode, rot) in zip(operands(vop, va, vb), got):
                if v in leaves:
                    assert (mode, x, rot) == leaves[v]
                    uses[v] += 1
                else:
                    assert mode == fold_ops.SLOT and rot == 0 and content[x] == v
            if len(got) == 1:
                assert (b, bm, br) == (0, fold_ops.SLOT, 0)
        for i, ins in zip(idx, phys):
            if ins[0] == ACC:
                assert ins[1] == vin[i][1]
            else:
                assert 0 <= ins[1] < prog.slots
                content[ins[1]] = vin[i][1]
                defined.add(vin[i][1])
        pc += size
    assert all(uses.values())  # no leaf is dropped
    # the ACCs keep their order
    accs = [vin[i][1] for i in prog.order if vin[i][0] == ACC]
    assert accs == sorted(accs) == list(range(len(prog.clusters)))
    # the live slots fit the slot class
    assert prog.slots <= fold_ops.slot_class(prog.slots) <= fold_ops.SLOT_CLASSES[-1]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", list(CIRCUITS) + ["sha"])
def test_scheduler_invariants(name, width):
    for fold in programs(name):
        prog = fold.program if width == fold.program.width else fold.program.with_width(width)
        check_bundles(prog)
        # the kernel's stream: each bundle filled to the width with PAD,
        # rotations of columns in [0, n)
        n = 48
        enc = prog.encode(n)
        assert len(enc) == width * len(prog.bundle_sizes)
        pad = (fold_ops.PAD, 0, 0, 0, fold_ops.SLOT, 0, fold_ops.SLOT, 0)
        for bi, bundle in enumerate(prog.bundles()):
            got = enc[bi * width:(bi + 1) * width]
            assert got[len(bundle):] == [pad] * (width - len(bundle))
            for rec, ins in zip(got, bundle):
                assert rec[:5] == ins[:5] and rec[6] == ins[6]
                for r, r0, mode in ((rec[5], ins[5], ins[4]), (rec[7], ins[7], ins[6])):
                    if mode == fold_ops.COLUMN:
                        assert 0 <= r < n and (r - r0) % n == 0
                    else:
                        assert r == r0 == 0


def run_stream(prog, arrays, coset_x, scalars):
    """csrc/fold.cu's loop in torch on the plain ops: the encoded stream of
    bundles (PADs included), each bundle's operands all read before any of
    its results is written (its warps run side by side), a LOAD's row
    (i + b) wrapped once."""
    from halo2_tpu_torch.ops.field import FieldCtx, add_mod_plain, mont_mul_plain, sub_mod_plain

    ctx = FieldCtx(prog.field)
    n = coset_x.shape[0]
    enc = prog.encode(n)
    rows = torch.arange(n)
    slots = [None] * prog.slots
    out = torch.zeros((len(prog.clusters), n, 16), dtype=torch.int32)
    fn = {fold_ops.ADD: add_mod_plain, fold_ops.SUB: sub_mod_plain, fold_ops.MUL: mont_mul_plain,
          fold_ops.NEG: lambda a, b, c: sub_mod_plain(torch.zeros_like(a), a, c)}

    def operand(v, mode, rot):
        if mode == fold_ops.SLOT:
            return slots[v]
        if mode == fold_ops.COLUMN:
            r = rows + rot
            return arrays[v][torch.where(r >= n, r - n, r)]
        return scalars[v].expand(n, 16) if mode == fold_ops.ENTRY else coset_x

    for bi in range(len(prog.bundle_sizes)):
        bundle = enc[bi * prog.width:(bi + 1) * prog.width]
        results = []
        for op, d, a, b, am, ar, bm, br in bundle:
            if op == fold_ops.PAD:
                continue
            x = operand(a, am, ar)
            if op == ACC:
                results.append((None, (d, x)))
            else:
                results.append((d, fn[op](x, operand(b, bm, br) if op != fold_ops.NEG else None, ctx)))
        for d, v in results:
            if d is None:
                out[v[0]] = v[1]
            else:
                slots[d] = v
    return out


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", ["bench_k8", "hash_k7", "sha"])
def test_the_kernels_stream_equals_the_plain_program(name, width):
    """The encoded stream, run as the kernel runs it, gives run_program_plain's
    limbs: part 0 of the part-wise engine and the last part of the row-sharded one."""
    folds = programs(name)
    for j, fold in enumerate([folds[0]] + folds[1:][-1:]):
        prog = fold.program if width == fold.program.width else fold.program.with_width(width)
        arrays, cx, scal = fold_inputs(fold, seed=j, n_rows=16)
        table = fold_ops.scalar_table(prog, scal, "cpu")
        cols = [arrays[i] for i in prog.array_ids]
        want = fold_ops.run_program_plain(prog, cols, cx, table)
        got = run_stream(prog, cols, cx, table)
        for c, cluster in enumerate(prog.clusters):
            assert torch.equal(got[c], want[cluster]), (name, j, cluster)


@pytest.mark.parametrize("name", list(CIRCUITS) + ["sha"])
def test_scalar_program_equals_scalar_table(name):
    for j, fold in enumerate(programs(name)):
        prog = fold.program
        sp = prog.scalar_program
        check_bundles(sp)
        S = len(prog.scalar_defs)
        counts = sp.counts()
        assert counts["ACC"] == S and counts["COSET_X"] == 0
        assert counts["LOAD"] == len(sp.array_ids) == 4 + fold.n_challenges
        assert counts["SCALAR"] == len(sp.scalar_defs) == sum(d[0] == "const" for d in prog.scalar_defs)
        assert sp.columns_read() == set(range(len(sp.array_ids)))
        _, _, scal = fold_inputs(fold, seed=j)
        want = fold_ops.scalar_table(prog, scal, "cpu")
        arrays = [(scal[nm] if ix < 0 else scal[nm][ix]).reshape(1, 16) for _, nm, ix in sp.array_ids]
        out = fold_ops.run_program_plain(sp, arrays, None, sp.consts("cpu"))
        got = torch.stack([out[i][0] for i in range(S)])
        assert want.shape == (S, 16) and torch.equal(got, want)


def test_launch_geometry_of_every_slot_class():
    assert ctypes.sizeof(fold_ops.FoldParams) <= 4096  # a kernel's parameters
    prev = 0
    for cls in fold_ops.SLOT_CLASSES:
        assert fold_ops.slot_class(cls) == cls and fold_ops.slot_class(prev + 1) == cls
        prev = cls
        for width in WIDTHS:
            for log_n in (14, 17):
                n = 1 << log_n
                threads, shared, blocks = fold_ops.launch_geometry(cls, n, width)
                # a warp for each instruction of a bundle, one row a lane
                assert threads == 32 * width and fold_ops.ROWS_PER_BLOCK == 32
                assert shared == cls * 32 * 32 <= fold_ops.MAX_SHARED == 227 * 1024
                assert blocks * 32 >= n > (blocks - 1) * 32
                if log_n == 14:
                    assert blocks >= 132  # a block for every SM of an H100 at 2^14 rows
    with pytest.raises(ValueError):
        fold_ops.slot_class(fold_ops.SLOT_CLASSES[-1] + 1)
    # the programs of the test circuits fit four blocks in an SM's 228 KB (1 KB a block reserved)
    for name in list(CIRCUITS) + ["sha"]:
        for fold in programs(name):
            assert 4 * (fold_ops.launch_geometry(fold.program.slots, 1 << 14)[1] + 1024) <= 228 * 1024


@pytest.mark.gpu
def test_scalar_table_is_one_launch_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    for name in CIRCUITS:
        for j, fold in enumerate(programs(name)):
            prog = fold.program
            _, _, scal = fold_inputs(fold, seed=j)
            want = fold_ops.scalar_table(prog, scal, "cpu")
            on_card = {k: ([t.cuda() for t in v] if k == "ch" else v.cuda()) for k, v in scal.items()}
            before = (fold_ops.LAUNCHES["fold_program"], sum(field_ew.LAUNCHES.values()))
            got = fold_ops.scalar_table(prog, on_card, "cuda")
            torch.cuda.synchronize()
            assert (fold_ops.LAUNCHES["fold_program"], sum(field_ew.LAUNCHES.values())) == (
                before[0] + 1, before[1])
            assert torch.equal(got.cpu(), want), (name, j)


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
def test_kernel_b_at_every_width_on_the_card(width):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    for name in list(CIRCUITS) + ["sha"]:
        for j, fold in enumerate(programs(name)):
            prog = fold.program.with_width(width)
            arrays, cx, scal = fold_inputs(fold, seed=j, n_rows=1000)
            table = fold_ops.scalar_table(prog, scal, "cpu")
            cols = [arrays[i] for i in prog.array_ids]
            want = fold_ops.run_program_plain(prog, cols, cx, table)
            got = fold_ops.run_program(prog, [c.cuda() for c in cols], cx.cuda(), table.cuda())
            torch.cuda.synchronize()
            for c in want:
                assert torch.equal(got[c].cpu(), want[c]), (name, j, c)
