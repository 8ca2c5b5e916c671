"""SHA-256 gadget over a 16-bit spread lookup table.

Mirrors `halo2_gadgets/src/sha256{.rs,/table16.rs,/table16/*}` (feature
`unstable`): the Table16 design from the halo2 book — every 32-bit word
lives in "dense" and "spread" form (spread interleaves zero bits so that
field addition of spreads computes carry-free base-4 digit sums; the even
digits of a spread-sum are the XOR and the odd digits the carries/AND),
with 16-bit units range-constrained by a 2^16-row lookup table.

Layout notes (documented deviations from the reference, same soundness):
  * The reference's (tag, dense, spread) table with tag-class range gates
    (spread_table.rs:27-43) is replaced by a tag-free (dense, spread)
    table plus a fixed per-row `shift` column: a w-bit piece is looked up
    as (dense*2^(16-w), spread*4^(16-w)), which enforces dense < 2^w and
    spread = spread(dense) in one row for every width uniformly.
  * The reference packs pieces into a hand-scheduled 10-column layout
    (compression/*.rs, message_schedule/*.rs, ~4.5k LoC); here every
    linear identity (piece recomposition, spread-sum even/odd splits,
    mod-2^32 additions) goes through one generic 12-term linear gate
    (3 rows x 4 advice columns with fixed coefficient columns + a fixed
    constant slot). More rows, far less machinery.
  * Sigma_0/Sigma_1/sigma_0/sigma_1 use the same piece decompositions as
    the spec (rotations/shifts realized as 4^k coefficients on spread
    pieces; base-4 digits of all sums stay <= 3, so every sum splits as
    spread(even) + 2*spread(odd)).

Public surface mirrors sha256.rs: `Sha256` digest gadget over
`BLOCK_SIZE` 32-bit words, `Table16Chip`/`Table16Config`.

A copy of `halo2_tpu/gadgets/sha256.py` on the port's front-end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..fields import Fp
from ..frontend import AssignedCell, Layouter, Region, Value
from ..plonk.constraint_system import ConstraintSystem
from ..poly import Rotation

P = Fp.MODULUS

BLOCK_SIZE = 16  # 32-bit words per block (sha256.rs BLOCK_SIZE)
DIGEST_SIZE = 8  # 32-bit words per digest (sha256.rs DIGEST_SIZE)

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

ROUND_CONSTANTS = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

MASK32 = (1 << 32) - 1


# ---------------------------------------------------------------------------
# Host helpers: spread arithmetic + reference SHA-256
# ---------------------------------------------------------------------------


def spread_bits(x: int, width: int = 16) -> int:
    """Interleave zero bits: bit i of x -> bit 2i (spread_table.rs spread)."""
    r = 0
    for i in range(width):
        if (x >> i) & 1:
            r |= 1 << (2 * i)
    return r


def even_odd_bits(s: int, digits: int) -> Tuple[int, int]:
    """Split a base-4 number (digits <= 3) into its even/odd bit planes:
    s = spread(even) + 2*spread(odd)."""
    even = odd = 0
    for i in range(digits):
        d = (s >> (2 * i)) & 3
        even |= (d & 1) << i
        odd |= (d >> 1) << i
    return even, odd


def _rotr(x: int, r: int) -> int:
    return ((x >> r) | (x << (32 - r))) & MASK32


def sha256_host_blocks(blocks: Sequence[Sequence[int]]) -> List[int]:
    """Reference SHA-256 compression over 16-word blocks (host oracle)."""
    state = list(IV)
    for block in blocks:
        w = list(block) + [0] * 48
        for r in range(16, 64):
            s0 = _rotr(w[r - 15], 7) ^ _rotr(w[r - 15], 18) ^ (w[r - 15] >> 3)
            s1 = _rotr(w[r - 2], 17) ^ _rotr(w[r - 2], 19) ^ (w[r - 2] >> 10)
            w[r] = (w[r - 16] + s0 + w[r - 7] + s1) & MASK32
        a, b, c, d, e, f, g, h = state
        for r in range(64):
            S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & g & MASK32)
            t1 = (h + S1 + ch + ROUND_CONSTANTS[r] + w[r]) & MASK32
            S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            t2 = (S0 + maj) & MASK32
            h, g, f, e, d, c, b, a = g, f, e, (d + t1) & MASK32, c, b, a, (t1 + t2) & MASK32
        state = [(s + v) & MASK32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]
    return state


def sha256_pad(message: bytes) -> List[List[int]]:
    """SHA-256 padding into 16-word blocks."""
    bitlen = len(message) * 8
    data = bytearray(message)
    data.append(0x80)
    while len(data) % 64 != 56:
        data.append(0)
    data += bitlen.to_bytes(8, "big")
    blocks = []
    for off in range(0, len(data), 64):
        blocks.append([
            int.from_bytes(data[off + 4 * i : off + 4 * i + 4], "big")
            for i in range(16)
        ])
    return blocks


# piece decompositions: (offsets implicitly cumulative), rotations, shifts
# Sigma_0(A) = rotr2 ^ rotr13 ^ rotr22 ; pieces 2,11,9,10   (table16 spec)
# Sigma_1(E) = rotr6 ^ rotr11 ^ rotr25 ; pieces 6,5,14,7
# sigma_0(W) = rotr7 ^ rotr18 ^ shr3   ; pieces 3,4,11,14
# sigma_1(W) = rotr17 ^ rotr19 ^ shr10 ; pieces 10,7,2,13
_SIGMA_DEFS = {
    "Sigma0": ([2, 11, 9, 10], [2, 13, 22], []),
    "Sigma1": ([6, 5, 14, 7], [6, 11, 25], []),
    "sigma0": ([3, 4, 11, 14], [7, 18], [3]),
    "sigma1": ([10, 7, 2, 13], [17, 19], [10]),
}


def _sigma_coeffs(widths: List[int], rots: List[int], shifts: List[int]) -> List[int]:
    """Spread-space coefficient of each piece in the XOR-sum."""
    offs = []
    o = 0
    for w in widths:
        offs.append(o)
        o += w
    assert o == 32
    coeffs = []
    for off in offs:
        c = 0
        for r in rots:
            c += 1 << (2 * ((off - r) % 32))
        for s in shifts:
            if off >= s:
                c += 1 << (2 * (off - s))
        coeffs.append(c)
    return coeffs


def _sigma_host(x: int, name: str) -> int:
    widths, rots, shifts = _SIGMA_DEFS[name]
    out = 0
    for r in rots:
        out ^= _rotr(x, r)
    for s in shifts:
        out ^= x >> s
    return out


# ---------------------------------------------------------------------------
# Config / chip
# ---------------------------------------------------------------------------


class Table16Config:
    def __init__(self, meta: ConstraintSystem):
        # lookup trio
        self.dense = meta.advice_column()
        self.spread = meta.advice_column()
        self.shift = meta.fixed_column()
        meta.enable_equality(self.dense)
        meta.enable_equality(self.spread)
        self.table_dense = meta.lookup_table_column()
        self.table_spread = meta.lookup_table_column()
        self.q_lookup = meta.complex_selector()

        dense, spread, shift, q_lookup = (
            self.dense, self.spread, self.shift, self.q_lookup
        )

        def lookup_map(cells):
            q = cells.query_selector(q_lookup)
            d = cells.query_advice(dense, Rotation.cur())
            s = cells.query_advice(spread, Rotation.cur())
            sh = cells.query_fixed(shift, Rotation.cur())
            return [
                (q * d * sh, self.table_dense),
                (q * s * sh * sh, self.table_spread),
            ]

        meta.lookup("spread range", lookup_map)

        # generic 12-term linear gate over a 3-row x 4-col window
        self.lin = [meta.advice_column() for _ in range(4)]
        self.coef = [meta.fixed_column() for _ in range(4)]
        self.const_col = meta.fixed_column()
        for col in self.lin:
            meta.enable_equality(col)
        self.q_lin = meta.selector()

        lin, coef, const_col, q_lin = self.lin, self.coef, self.const_col, self.q_lin

        def lin_gate(cells):
            q = cells.query_selector(q_lin)
            acc = cells.query_fixed(const_col, Rotation.cur())
            for i in range(3):
                for j in range(4):
                    acc = acc + (
                        cells.query_fixed(coef[j], Rotation(i))
                        * cells.query_advice(lin[j], Rotation(i))
                    )
            return [q * acc]

        meta.create_gate("linear combination", lin_gate)


@dataclass
class SpreadCell:
    """A w-bit unit in dense+spread form, lookup-constrained."""

    dense: AssignedCell
    spread: AssignedCell
    width: int
    value: Optional[int]


@dataclass
class WordCells:
    """A 32-bit word: single dense cell (+ optional 16-bit halves)."""

    cell: AssignedCell
    value: Optional[int]


class Table16Chip:
    """The SHA-256 chip (table16.rs Table16Chip)."""

    def __init__(self, config: Table16Config):
        self.config = config

    @staticmethod
    def configure(meta: ConstraintSystem) -> Table16Config:
        return Table16Config(meta)

    def load_table(self, layouter: Layouter):
        """Load the 2^16-row (dense, spread) table (spread_table.rs load)."""
        config = self.config

        def in_table(table):
            for d in range(1 << 16):
                table.assign_cell(config.table_dense, d, d, "dense")
                table.assign_cell(config.table_spread, d, spread_bits(d), "spread")

        layouter.assign_table("spread table", in_table)

    # -- primitive assignment helpers (all within caller-provided regions) --

    def _piece(self, region: Region, row: int, value: Optional[int], width: int
               ) -> SpreadCell:
        """Lookup row for a w-bit piece: (dense*2^(16-w), spread*4^(16-w))."""
        config = self.config
        region.enable_selector(config.q_lookup, row)
        sh = 1 << (16 - width)
        region.assign_fixed(config.shift, row, Value.known(sh), "shift")
        if value is None:
            dv = sv = Value.unknown()
        else:
            assert 0 <= value < (1 << width), (value, width)
            dv = Value.known(value)
            sv = Value.known(spread_bits(value, width))
        d = region.assign_advice(config.dense, row, dv, "dense")
        s = region.assign_advice(config.spread, row, sv, "spread")
        return SpreadCell(d, s, width, value)

    def _linear(self, region: Region, row: int,
                terms: List[Tuple[AssignedCell, int]], constant: int = 0):
        """One 12-term relation: sum coef*cell + constant = 0 (mod p)."""
        config = self.config
        assert len(terms) <= 12
        region.enable_selector(config.q_lin, row)
        region.assign_fixed(config.const_col, row, Value.known(constant % P), "const")
        for i in range(3):
            for j in range(4):
                idx = i * 4 + j
                if idx < len(terms):
                    cell, c = terms[idx]
                    cell.copy_advice(region, config.lin[j], row + i, f"t{idx}")
                    region.assign_fixed(config.coef[j], row + i, Value.known(c % P), "c")
                else:
                    region.assign_advice(config.lin[j], row + i, Value.known(0), "z")
                    region.assign_fixed(config.coef[j], row + i, Value.known(0), "c0")
            if i > 0:
                region.assign_fixed(config.const_col, row + i, Value.known(0), "cz")

    # -- mid-level ops --

    def witness_word(self, layouter: Layouter, value: Optional[int]) -> WordCells:
        """Witness a 32-bit word: lo/hi 16-bit lookups + recomposition."""
        chip = self

        def in_region(region: Region):
            lo = chip._piece(region, 0, None if value is None else value & 0xFFFF, 16)
            hi = chip._piece(region, 1, None if value is None else value >> 16, 16)
            wv = Value.unknown() if value is None else Value.known(value)
            w = region.assign_advice(chip.config.lin[0], 2, wv, "word")
            # word - lo - 2^16 hi = 0
            chip._linear(region, 3, [(w, 1), (lo.dense, -1), (hi.dense, -(1 << 16))])
            return WordCells(w, value)

        return layouter.assign_region("witness word", in_region)

    def constant_word(self, layouter: Layouter, value: int) -> WordCells:
        def in_region(region: Region):
            w = region.assign_advice(
                self.config.lin[0], 0, Value.known(value), "const word"
            )
            region.constrain_constant(w.cell(), value)
            return WordCells(w, value)

        return layouter.assign_region("constant word", in_region)

    def _decompose_pieces(self, region: Region, row: int, word: WordCells,
                          widths: List[int]) -> Tuple[List[SpreadCell], int]:
        """Piece lookups + binding relation word = sum 2^off * piece."""
        pieces = []
        off = 0
        vals: List[Optional[int]] = []
        for w in widths:
            v = None if word.value is None else (word.value >> off) & ((1 << w) - 1)
            vals.append(v)
            off += w
        for i, (w, v) in enumerate(zip(widths, vals)):
            pieces.append(self._piece(region, row + i, v, w))
        r = row + len(widths)
        terms = [(word.cell, 1)]
        off = 0
        for w, pc in zip(widths, pieces):
            terms.append((pc.dense, -(1 << off)))
            off += w
        self._linear(region, r, terms)
        return pieces, r + 3

    def _even_odd_split(self, region: Region, row: int,
                        spread_terms: List[Tuple[AssignedCell, int]],
                        constant: int, sum_value: Optional[int]
                        ) -> Tuple[List[SpreadCell], List[SpreadCell], int]:
        """Witness even/odd 16-bit planes of a spread-space sum and constrain
        sum = sp(even) + 2 sp(odd) (both split lo/hi at digit 16)."""
        if sum_value is None:
            ev = od = [None, None]
        else:
            even, odd = even_odd_bits(sum_value, 32)
            ev = [even & 0xFFFF, even >> 16]
            od = [odd & 0xFFFF, odd >> 16]
        even_cells = [
            self._piece(region, row, ev[0], 16),
            self._piece(region, row + 1, ev[1], 16),
        ]
        odd_cells = [
            self._piece(region, row + 2, od[0], 16),
            self._piece(region, row + 3, od[1], 16),
        ]
        r = row + 4
        terms = list(spread_terms)
        terms += [
            (even_cells[0].spread, -1),
            (even_cells[1].spread, -(1 << 32)),
            (odd_cells[0].spread, -2),
            (odd_cells[1].spread, -2 * (1 << 32)),
        ]
        self._linear(region, r, terms, constant)
        return even_cells, odd_cells, r + 3

    def sigma(self, layouter: Layouter, word: WordCells, name: str
              ) -> Tuple[List[SpreadCell], Optional[int]]:
        """Sigma/sigma op: returns the even (XOR result) 16-bit planes."""
        widths, rots, shifts = _SIGMA_DEFS[name]
        coeffs = _sigma_coeffs(widths, rots, shifts)
        chip = self

        def in_region(region: Region):
            pieces, row = chip._decompose_pieces(region, 0, word, widths)
            if word.value is None:
                sum_value = None
            else:
                sum_value = 0
                off = 0
                for w, c in zip(widths, coeffs):
                    pv = (word.value >> off) & ((1 << w) - 1)
                    sum_value += spread_bits(pv, w) * c
                    off += w
            spread_terms = [(pc.spread, c) for pc, c in zip(pieces, coeffs)]
            even, _odd, _ = chip._even_odd_split(region, row, spread_terms, 0, sum_value)
            return even

        even = layouter.assign_region(f"{name}", in_region)
        out = None if word.value is None else _sigma_host(word.value, name)
        return even, out

    def _spread_halves(self, layouter: Layouter, word: WordCells) -> List[SpreadCell]:
        """Look up the lo/hi spread halves of a word (bound to the word)."""
        chip = self

        def in_region(region: Region):
            lo = chip._piece(
                region, 0, None if word.value is None else word.value & 0xFFFF, 16
            )
            hi = chip._piece(
                region, 1, None if word.value is None else word.value >> 16, 16
            )
            chip._linear(
                region, 2, [(word.cell, 1), (lo.dense, -1), (hi.dense, -(1 << 16))]
            )
            return [lo, hi]

        return layouter.assign_region("spread halves", in_region)

    def _add_mod32(self, layouter: Layouter,
                   terms: List[Tuple[AssignedCell, int, Optional[int]]],
                   constant: int = 0) -> WordCells:
        """out = (sum coef*value + constant) mod 2^32; carry is a 3-bit
        lookup piece; out is a fresh word with lo/hi range lookups."""
        chip = self
        known = all(v is not None for _, _, v in terms)
        if known:
            total = constant + sum(c * v for _, c, v in terms)
            assert total >= 0
            out_val: Optional[int] = total & MASK32
            carry: Optional[int] = total >> 32
            assert carry < 8, "carry exceeds 3 bits"
        else:
            out_val = carry = None

        def in_region(region: Region):
            lo = chip._piece(region, 0, None if out_val is None else out_val & 0xFFFF, 16)
            hi = chip._piece(region, 1, None if out_val is None else out_val >> 16, 16)
            cy = chip._piece(region, 2, carry, 3)
            lin_terms = [(cell, c) for cell, c, _ in terms]
            lin_terms += [
                (lo.dense, -1),
                (hi.dense, -(1 << 16)),
                (cy.dense, -(1 << 32)),
            ]
            chip._linear(region, 3, lin_terms, constant)
            wv = Value.unknown() if out_val is None else Value.known(out_val)
            w = region.assign_advice(chip.config.lin[0], 6, wv, "sum word")
            chip._linear(
                region, 7, [(w, 1), (lo.dense, -1), (hi.dense, -(1 << 16))]
            )
            return w

        w = layouter.assign_region("add mod 2^32", in_region)
        return WordCells(w, out_val)

    # -- SHA-256 structure --

    def message_schedule(self, layouter: Layouter,
                         words: List[WordCells]) -> List[WordCells]:
        """W_16..W_63 from the 16 input words (message_schedule.rs)."""
        w = list(words)
        for r in range(16, 64):
            s0_even, s0 = self.sigma(layouter, w[r - 15], "sigma0")
            s1_even, s1 = self.sigma(layouter, w[r - 2], "sigma1")
            terms = [
                (w[r - 16].cell, 1, w[r - 16].value),
                (s0_even[0].dense, 1, None if s0 is None else s0 & 0xFFFF),
                (s0_even[1].dense, 1 << 16, None if s0 is None else s0 >> 16),
                (w[r - 7].cell, 1, w[r - 7].value),
                (s1_even[0].dense, 1, None if s1 is None else s1 & 0xFFFF),
                (s1_even[1].dense, 1 << 16, None if s1 is None else s1 >> 16),
            ]
            w.append(self._add_mod32(layouter, terms))
        return w

    def compress(self, layouter: Layouter, state: List[WordCells],
                 w: List[WordCells]) -> List[WordCells]:
        """64 rounds + feed-forward (compression.rs)."""
        a, b, c, d, e, f, g, h = state
        SP_ONES = spread_bits(0xFFFF, 16)
        for r in range(64):
            # Sigma1(E)
            s1_even, s1 = self.sigma(layouter, e, "Sigma1")
            # Ch(E, F, G): odd(spE+spF) + odd(sp(~E)+spG)
            spe = self._spread_halves(layouter, e)
            spf = self._spread_halves(layouter, f)
            spg = self._spread_halves(layouter, g)
            chip = self

            def ch_region(region: Region, spe=spe, spf=spf, spg=spg, e=e, f=f, g=g):
                if e.value is None or f.value is None:
                    pv = None
                else:
                    pv = (
                        spread_bits(e.value & 0xFFFF, 16)
                        + spread_bits(f.value & 0xFFFF, 16)
                        + (1 << 32) * (
                            spread_bits(e.value >> 16, 16)
                            + spread_bits(f.value >> 16, 16)
                        )
                    )
                _, p_odd, row = chip._even_odd_split(
                    region, 0,
                    [(spe[0].spread, 1), (spf[0].spread, 1),
                     (spe[1].spread, 1 << 32), (spf[1].spread, 1 << 32)],
                    0, pv,
                )
                if e.value is None or g.value is None:
                    qv = None
                else:
                    ne = (~e.value) & MASK32
                    qv = (
                        spread_bits(ne & 0xFFFF, 16)
                        + spread_bits(g.value & 0xFFFF, 16)
                        + (1 << 32) * (
                            spread_bits(ne >> 16, 16)
                            + spread_bits(g.value >> 16, 16)
                        )
                    )
                # spread(~E) = SP_ONES - spread(E) per half
                _, q_odd, _ = chip._even_odd_split(
                    region, row,
                    [(spe[0].spread, -1), (spg[0].spread, 1),
                     (spe[1].spread, -(1 << 32)), (spg[1].spread, 1 << 32)],
                    SP_ONES + (1 << 32) * SP_ONES, qv,
                )
                return p_odd, q_odd

            p_odd, q_odd = layouter.assign_region(f"Ch r{r}", ch_region)
            if e.value is None or f.value is None or g.value is None:
                ch_val = None
            else:
                ch_val = (e.value & f.value) ^ ((~e.value) & g.value & MASK32)

            # H' = H + Sigma1 + Ch + K + W
            hp_terms = [
                (h.cell, 1, h.value),
                (s1_even[0].dense, 1, None if s1 is None else s1 & 0xFFFF),
                (s1_even[1].dense, 1 << 16, None if s1 is None else s1 >> 16),
                (p_odd[0].dense, 1, p_odd[0].value),
                (p_odd[1].dense, 1 << 16, p_odd[1].value),
                (q_odd[0].dense, 1, q_odd[0].value),
                (q_odd[1].dense, 1 << 16, q_odd[1].value),
                (w[r].cell, 1, w[r].value),
            ]
            h_prime = self._add_mod32(layouter, hp_terms, ROUND_CONSTANTS[r])

            # Sigma0(A), Maj(A, B, C)
            s0_even, s0 = self.sigma(layouter, a, "Sigma0")
            spa = self._spread_halves(layouter, a)
            spb = self._spread_halves(layouter, b)
            spc = self._spread_halves(layouter, c)

            def maj_region(region: Region, spa=spa, spb=spb, spc=spc, a=a, b=b, c=c):
                if a.value is None or b.value is None or c.value is None:
                    mv = None
                else:
                    mv = sum(
                        (
                            spread_bits(x & 0xFFFF, 16)
                            + (1 << 32) * spread_bits(x >> 16, 16)
                        )
                        for x in (a.value, b.value, c.value)
                    )
                _, m_odd, _ = chip._even_odd_split(
                    region, 0,
                    [(spa[0].spread, 1), (spb[0].spread, 1), (spc[0].spread, 1),
                     (spa[1].spread, 1 << 32), (spb[1].spread, 1 << 32),
                     (spc[1].spread, 1 << 32)],
                    0, mv,
                )
                return m_odd

            m_odd = layouter.assign_region(f"Maj r{r}", maj_region)

            # E' = D + H' ; A' = H' + Sigma0 + Maj
            e_new = self._add_mod32(
                layouter, [(d.cell, 1, d.value), (h_prime.cell, 1, h_prime.value)]
            )
            a_terms = [
                (h_prime.cell, 1, h_prime.value),
                (s0_even[0].dense, 1, None if s0 is None else s0 & 0xFFFF),
                (s0_even[1].dense, 1 << 16, None if s0 is None else s0 >> 16),
                (m_odd[0].dense, 1, m_odd[0].value),
                (m_odd[1].dense, 1 << 16, m_odd[1].value),
            ]
            a_new = self._add_mod32(layouter, a_terms)
            a, b, c, d, e, f, g, h = a_new, a, b, c, e_new, e, f, g

        return [a, b, c, d, e, f, g, h]

    def initialization_vector(self, layouter: Layouter) -> List[WordCells]:
        return [self.constant_word(layouter, v) for v in IV]


class Sha256:
    """The gadget-level digest (sha256.rs Sha256)."""

    def __init__(self, chip: Table16Chip):
        self.chip = chip

    def digest_blocks(self, layouter: Layouter,
                      blocks: List[List[Optional[int]]]) -> List[WordCells]:
        chip = self.chip
        state = chip.initialization_vector(layouter)
        for block in blocks:
            words = [chip.witness_word(layouter, v) for v in block]
            w = chip.message_schedule(layouter, words)
            out = chip.compress(layouter, state, w)
            state = [
                chip._add_mod32(
                    layouter, [(s.cell, 1, s.value), (o.cell, 1, o.value)]
                )
                for s, o in zip(state, out)
            ]
        return state

    def digest_bytes(self, layouter: Layouter, message: Optional[bytes],
                     num_blocks: int) -> List[WordCells]:
        if message is None:
            blocks: List[List[Optional[int]]] = [[None] * 16] * num_blocks
        else:
            blocks = sha256_pad(message)
            assert len(blocks) == num_blocks
        return self.digest_blocks(layouter, blocks)
