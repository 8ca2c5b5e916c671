"""Kernel B's program (ops/fold.py): the quotient fold recorded once and
interpreted, against the evaluator's eager fold (plonk/evaluation.py).

For each test circuit the fold machinery is built from the constraint
system alone (a proving key's shape, no keygen: the fold reads only the
layout and the constraint system), and every part's fold (each c_lo) runs
on seeded random columns of 64 rows: `run_program_plain` of the recorded
program equals the eager walk bit for bit, at the part-wise engine's
rotations and at the row-sharded engine's (rotations scaled by the number
of parts), with the instructions scheduled into bundles of 1, 2, 4 (the
default) and 8. MulCircuit (k = 4, also as a batch of two proofs), BenchCircuit
(k = 8), HashCircuit (k = 7) and SinsemillaCircuit (k = 11) have their
selectors compressed from a synthesis, as keygen compresses them;
ShaCircuit's real assignment needs the 2^16-row spread table at k = 17, so
its selectors are compressed from an assignment where all of them share a
row (each in a fixed column of its own) and part 0 alone is run. On the
card (`gpu`) kernel B equals the plain program on the same inputs.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from halo2_tpu_torch import circuits
from halo2_tpu_torch.fields import Fp
from halo2_tpu_torch.frontend.floor_planner import synthesize_circuit
from halo2_tpu_torch.ops import fold as fold_ops
from halo2_tpu_torch.ops.field import FieldCtx, ints_to_limbs
from halo2_tpu_torch.plonk.constraint_system import ConstraintSystem, configure_circuit
from halo2_tpu_torch.plonk.evaluation import Evaluator
from halo2_tpu_torch.plonk.keygen import Assembly

torch.set_num_threads(1)

ROWS = 64


def fold_machinery(circuit, k, num_proofs=1, synthesize=True, n_rows=ROWS, mesh=False):
    """(machinery, item kinds, L) of the part-wise (or, with `mesh`, the
    row-sharded) engine for `circuit` at k, from its constraint system."""
    cs = ConstraintSystem()
    config = configure_circuit(circuit, cs)
    degree = cs.degree()  # the domain's degree is taken before compression, as keygen takes it
    if synthesize:
        assembly = Assembly(Fp, k, cs, 1 << k)
        synthesize_circuit(assembly, circuit.without_witnesses(), config, cs.constants)
        selectors = assembly.selectors
    else:
        selectors = [[True] for _ in range(cs.num_selectors)]
    cs.compress_selectors([list(s) for s in selectors])
    ext_k = k
    while (1 << ext_k) < (1 << k) * (degree - 1):
        ext_k += 1
    cs_degree = cs.degree()
    chunk_len = cs_degree - 2
    nsets = -(-len(cs.permutation.columns) // chunk_len)
    domain = SimpleNamespace(k=k, extended_k=ext_k, ctx=FieldCtx(Fp))
    vk = SimpleNamespace(cs=cs, domain=domain, cs_degree=cs_degree, curve=SimpleNamespace(SCALAR=Fp))
    pk = SimpleNamespace(vk=vk, fixed_polys=[None] * cs.num_fixed_columns, l0=None, l_last=None,
                         l_active_row=None,
                         permutation=SimpleNamespace(polys=[None] * len(cs.permutation.columns)))
    lookup = SimpleNamespace(product_poly=None, permuted_input_poly=None, permuted_table_poly=None)
    mach = Evaluator(pk)._fold_machinery(
        [[None] * cs.num_advice_columns] * num_proofs, [[None] * cs.num_instance_columns] * num_proofs,
        [0] * cs.num_challenges, [[lookup] * len(cs.lookups)] * num_proofs,
        [SimpleNamespace(sets=[SimpleNamespace(poly=None)] * nsets)] * num_proofs,
        n_rows=n_rows, rot_scale=(1 << (ext_k - k)) if mesh else 1)
    kinds = {"gate"} if cs.gates else set()
    if nsets:
        kinds |= {"perm_l0", "perm_llast", "perm_prod"} | ({"perm_cont"} if nsets > 1 else set())
    if cs.lookups:
        kinds |= {"lk_l0", "lk_llast", "lk_prod", "lk_l0_as", "lk_as_prev"}
    return mach, kinds, ext_k - k


def lazy(rng, shape):
    """Montgomery limbs of values uniform below 2p, the edge values 0, 1,
    p - 1 and 2p - 1 among them."""
    p = Fp.MODULUS
    n = int(np.prod(shape))
    vals = [0, 1, p - 1, 2 * p - 1][:n] + [int.from_bytes(rng.bytes(40), "little") % (2 * p)
                                           for _ in range(n - 4)]
    vals = [vals[i] for i in rng.permutation(n)]
    return torch.as_tensor(ints_to_limbs(vals).reshape(*shape, 16))


def fold_inputs(fold, seed, n_rows=ROWS, device="cpu"):
    rng = np.random.default_rng(seed)
    arrays = {i: lazy(rng, (n_rows,)).to(device) for i in fold.needed_idx}
    coset_x = lazy(rng, (n_rows,)).to(device)
    scal = {name: lazy(rng, ()).to(device) for name in ("y", "beta", "gamma", "theta")}
    scal["ch"] = [lazy(rng, ()).to(device) for _ in range(fold.n_challenges)]
    return arrays, coset_x, scal


WIDTHS = (1, 2, fold_ops.BUNDLE_WIDTH, 8)
_EAGER = {}  # (fold id, seed, rows) -> the eager fold's output, shared by the widths' cases


def check_fold(fold, seed, n_rows=ROWS, width=fold_ops.BUNDLE_WIDTH):
    arrays, coset_x, scal = fold_inputs(fold, seed, n_rows)
    prog = fold.program if width == fold.program.width else fold.program.with_width(width)
    assert prog.width == width and max(prog.bundle_sizes) <= width
    key = (id(fold), seed, n_rows)
    if key not in _EAGER:
        _EAGER[key] = (fold, fold(arrays, coset_x, scal))  # CPU tensors: the eager walk
    eager = _EAGER[key][1]
    table = fold_ops.scalar_table(prog, scal, "cpu")
    plain = fold_ops.run_program_plain(prog, [arrays[i] for i in prog.array_ids], coset_x, table)
    assert list(plain) == list(eager) == list(prog.clusters)
    for c in eager:
        assert plain[c].shape == (n_rows, 16)
        assert torch.equal(plain[c], eager[c]), f"cluster {c}"
    # the slots the program reads are ones it wrote before
    live = set()
    for op, d, a, b, am, _, bm, _ in prog.instrs:
        for v, mode in ((a, am), (b, bm))[:1 if op in (fold_ops.NEG, fold_ops.ACC) else 2]:
            assert mode != fold_ops.SLOT or v in live
        if op != fold_ops.ACC:
            assert 0 <= d < prog.slots
            live.add(d)
    return prog


CIRCUITS = {
    "mul_k4": (circuits.MulCircuit(7, 2, 3), 4, 1),
    "mul_k4_two_proofs": (circuits.MulCircuit(7, 2, 3), 4, 2),
    "bench_k8": (circuits.bench_circuit_for_k(8), 8, 1),
    "hash_k7": (circuits.HashCircuit([7, 11]), 7, 1),
    "sinsemilla_k11": (circuits.SinsemillaCircuit(), 11, 1),
}
KINDS = set()


_MACHINERY = {}


def machinery(name, mesh):
    """fold_machinery of CIRCUITS[name], made once per engine for the widths' cases."""
    if (name, mesh) not in _MACHINERY:
        circuit, k, proofs = CIRCUITS[name]
        _MACHINERY[name, mesh] = fold_machinery(circuit, k, proofs, mesh=mesh)
    return _MACHINERY[name, mesh]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mesh", [False, True], ids=["parts", "mesh"])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_program_equals_the_eager_fold_on_every_part(name, mesh, width):
    k = CIRCUITS[name][1]
    mach, kinds, L = machinery(name, mesh)
    KINDS.update(kinds)
    for c_lo in range(L + 1):
        fold, needed = mach.fold_for(c_lo)
        assert fold.needed_idx == needed and mach.fold_for(c_lo)[0] is fold  # made once per c_lo
        prog = check_fold(fold, seed=100 * c_lo + k, width=width)
        assert prog.counts()["ACC"] == len(prog.clusters) and min(prog.clusters) >= c_lo


@pytest.mark.parametrize("width", WIDTHS)
def test_sha256_program_equals_the_eager_fold(width):
    if "sha" not in _MACHINERY:
        _MACHINERY["sha"] = fold_machinery(circuits.ShaCircuit(None, 1), 17, synthesize=False)
    mach, kinds, L = _MACHINERY["sha"]
    KINDS.update(kinds)
    assert L == 3
    prog = check_fold(mach.fold_for(0)[0], seed=17, width=width)
    assert prog.counts()["MUL"] > 50 and sorted(prog.clusters) == [1, 2, 3]


def test_every_item_kind_is_recorded():
    for name, (circuit, k, proofs) in CIRCUITS.items():
        KINDS.update(fold_machinery(circuit, k, proofs)[1])
    assert KINDS == {"gate", "perm_l0", "perm_llast", "perm_cont", "perm_prod", "lk_l0", "lk_llast",
                     "lk_prod", "lk_l0_as", "lk_as_prev"}


def test_recorder_slots_scalars_and_rotation():
    """A small walk: scalar-only operations go to the scalar table (shared
    when equal), each leaf is loaded just before its use, a rotation wraps
    as torch.roll does, dead values are dropped and slots are reused."""
    def walk(vecs, coset_x, sc, const_vec):
        a, b = vecs[3], vecs[5]
        two = const_vec(2) * sc.y  # scalar * scalar: a table entry
        _dead = a * b  # no ACC needs it
        t = (a.rotate(-1) - b.rotate(2)) * two + coset_x * (sc.beta * 7)
        u = -(t * t) + sc.ch[0]
        return {0: t, 1: u * const_vec(2) * sc.y}

    prog = fold_ops.record(Fp, walk, (3, 5), 1)
    assert prog.array_ids == (3, 5) and prog.clusters == (0, 1)
    defs = prog.scalar_defs
    assert ("const", 2) in defs and (fold_ops.MUL, defs.index(("const", 2)), defs.index(("input", "y", -1))) in defs
    assert defs.count(("const", 2)) == 1 and len(set(defs)) == len(defs)
    # in bundles of one, the recording's order, and at most the four slots
    # of a linear scan over the recording
    assert prog.counts()["LOAD"] == 2 and prog.with_width(1).slots <= 4
    assert prog.with_width(1).bundle_sizes == [1] * len(prog.instrs)
    rng = np.random.default_rng(5)
    arrays, cx = [lazy(rng, (ROWS,)) for _ in range(2)], lazy(rng, (ROWS,))
    scal = {name: lazy(rng, ()) for name in ("y", "beta", "gamma", "theta")}
    scal["ch"] = [lazy(rng, ())]
    table = fold_ops.scalar_table(prog, scal, "cpu")
    got = fold_ops.run_program_plain(prog, arrays, cx, table)
    from halo2_tpu_torch.poly import FVec

    ctx = FieldCtx(Fp)
    want = walk({3: FVec(Fp, arrays[0]), 5: FVec(Fp, arrays[1])}, FVec(Fp, cx),
                SimpleNamespace(y=FVec(Fp, scal["y"]), beta=FVec(Fp, scal["beta"]),
                                ch=[FVec(Fp, scal["ch"][0])]),
                lambda c: FVec.fill(Fp, ROWS, c, "cpu"))
    for c in (0, 1):
        assert torch.equal(got[c], want[c].vals)
    # torch.roll's rule: row i of a rotation by r reads row (i + r) mod n
    assert torch.equal(torch.roll(arrays[0], 1, 0)[5], arrays[0][4])
    assert ctx.decode_ints(got[0][:1]) == ctx.decode_ints(want[0].vals[:1])


@pytest.mark.gpu
def test_kernel_b_equals_the_plain_program_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    for name, (circuit, k, proofs) in CIRCUITS.items():
        for mesh in (False, True):
            mach, _, L = fold_machinery(circuit, k, proofs, mesh=mesh, n_rows=1000)
            for c_lo in range(L + 1):
                fold = mach.fold_for(c_lo)[0]
                arrays, cx, scal = fold_inputs(fold, seed=c_lo, n_rows=1000, device="cuda")
                prog = fold.program
                table = fold_ops.scalar_table(prog, scal, "cuda")
                cols = [arrays[i] for i in prog.array_ids]
                before = fold_ops.LAUNCHES["fold_program"]
                got = fold(arrays, cx, scal)
                torch.cuda.synchronize()
                assert fold_ops.LAUNCHES["fold_program"] == before + 2  # the scalar table, the fold
                want = fold_ops.run_program_plain(prog, cols, cx, table)
                eager = fold.eager(arrays, cx, scal)
                for c in want:
                    assert torch.equal(got[c], want[c]) and torch.equal(got[c], eager[c]), (name, c_lo, c)
