"""In-circuit Poseidon: the Pow5 chip and the Sponge/Hash gadgets.

Mirrors `halo2_gadgets/src/poseidon.rs` and `poseidon/pow5.rs`:
  * `Pow5Config`: WIDTH state advice columns + 1 partial-sbox advice +
    2*WIDTH fixed round-constant columns; gates `full round` (1 round/row),
    `partial rounds` (2 rounds/row via the m_inv linearisation trick,
    pow5.rs:117-163) and `pad-and-add` (pow5.rs:165-190).
  * `Pow5Chip.permute`: load state, half_full full rounds, half_partial
    double-partial rounds, half_full full rounds (pow5.rs:231-272).
  * Sponge instructions initial_state / add_input / get_output
    (pow5.rs:283-395) and the gadget-level `Sponge`/`Hash` drivers
    (poseidon.rs:104-248).

Witness math is host-side ints mod p (the proving path consumes the
resulting columns as limb tensors at commit time).

A copy of `halo2_tpu/gadgets/poseidon.py` on the port's front-end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Type

from ..fields import FieldElement
from ..frontend import AssignedCell, Layouter, Region, Value
from ..plonk.assigned import Assigned
from ..plonk.constraint_system import ConstraintSystem
from ..poly import Rotation
from .poseidon_primitives import ConstantLength, Spec


def _as_int(v, p: int) -> int:
    if isinstance(v, Assigned):
        if v.den % p == 0:
            return 0
        return v.num * pow(v.den, -1, p) % p
    if isinstance(v, FieldElement):
        return v.v
    return int(v) % p


@dataclass
class Pow5Config:
    state: List[object]  # WIDTH advice columns
    partial_sbox: object
    rc_a: List[object]
    rc_b: List[object]
    s_full: object
    s_partial: object
    s_pad_and_add: object
    half_full_rounds: int
    half_partial_rounds: int
    round_constants: List[List[int]]
    m_reg: List[List[int]]
    m_inv: List[List[int]]
    spec: Type[Spec]


class Pow5Chip:
    """Poseidon x^5 chip (pow5.rs:43-227)."""

    def __init__(self, config: Pow5Config):
        self.config = config

    @staticmethod
    def configure(meta: ConstraintSystem, spec: Type[Spec], state, partial_sbox,
                  rc_a, rc_b) -> Pow5Config:
        width = spec.T
        rate = spec.RATE
        assert rate == width - 1
        assert spec.full_rounds() % 2 == 0 and spec.partial_rounds() % 2 == 0
        round_constants, m_reg, m_inv = spec.constants()

        for column in list(state) + list(rc_b):
            meta.enable_equality(column)

        s_full = meta.selector()
        s_partial = meta.selector()
        s_pad_and_add = meta.selector()

        def pow_5(v):
            v2 = v * v
            return v2 * v2 * v

        def full_round_gate(cells):
            s = cells.query_selector(s_full)
            exprs = []
            cur = [cells.query_advice(state[i], Rotation.cur()) for i in range(width)]
            rc = [cells.query_fixed(rc_a[i], Rotation.cur()) for i in range(width)]
            nxt = [cells.query_advice(state[i], Rotation.next()) for i in range(width)]
            sboxed = [pow_5(cur[i] + rc[i]) for i in range(width)]
            for next_idx in range(width):
                expr = None
                for idx in range(width):
                    term = sboxed[idx] * m_reg[next_idx][idx]
                    expr = term if expr is None else expr + term
                exprs.append(s * (expr - nxt[next_idx]))
            return exprs

        meta.create_gate("full round", full_round_gate)

        def partial_round_gate(cells):
            s = cells.query_selector(s_partial)
            cur = [cells.query_advice(state[i], Rotation.cur()) for i in range(width)]
            nxt = [cells.query_advice(state[i], Rotation.next()) for i in range(width)]
            mid_0 = cells.query_advice(partial_sbox, Rotation.cur())
            rca = [cells.query_fixed(rc_a[i], Rotation.cur()) for i in range(width)]
            rcb = [cells.query_fixed(rc_b[i], Rotation.cur()) for i in range(width)]

            def mid(idx):
                acc = mid_0 * m_reg[idx][0]
                for cur_idx in range(1, width):
                    acc = acc + (cur[cur_idx] + rca[cur_idx]) * m_reg[idx][cur_idx]
                return acc

            def nxt_lin(idx):
                acc = None
                for next_idx in range(width):
                    term = nxt[next_idx] * m_inv[idx][next_idx]
                    acc = term if acc is None else acc + term
                return acc

            exprs = [s * (pow_5(cur[0] + rca[0]) - mid_0)]
            exprs.append(s * (pow_5(mid(0) + rcb[0]) - nxt_lin(0)))
            for idx in range(1, width):
                exprs.append(s * (mid(idx) + rcb[idx] - nxt_lin(idx)))
            return exprs

        meta.create_gate("partial rounds", partial_round_gate)

        def pad_and_add_gate(cells):
            s = cells.query_selector(s_pad_and_add)
            exprs = []
            for idx in range(rate):
                initial = cells.query_advice(state[idx], Rotation.prev())
                inp = cells.query_advice(state[idx], Rotation.cur())
                out = cells.query_advice(state[idx], Rotation.next())
                exprs.append(s * (initial + inp - out))
            initial_rate = cells.query_advice(state[rate], Rotation.prev())
            output_rate = cells.query_advice(state[rate], Rotation.next())
            exprs.append(s * (initial_rate - output_rate))
            return exprs

        meta.create_gate("pad-and-add", pad_and_add_gate)

        return Pow5Config(
            list(state), partial_sbox, list(rc_a), list(rc_b),
            s_full, s_partial, s_pad_and_add,
            spec.full_rounds() // 2, spec.partial_rounds() // 2,
            round_constants, m_reg, m_inv, spec,
        )

    # ---- PoseidonInstructions ----
    def permute(self, layouter: Layouter, initial_state: List[AssignedCell]) -> List[AssignedCell]:
        config = self.config
        width = config.spec.T
        p = config.spec.FIELD.MODULUS

        def in_region(region: Region):
            # load initial state (pow5.rs:540-552)
            state = [
                initial_state[i].copy_advice(region, config.state[i], 0, f"load state_{i}")
                for i in range(width)
            ]

            def vals(cells) -> Optional[List[int]]:
                out = []
                for c in cells:
                    if c.value().is_none():
                        return None
                    out.append(_as_int(c.value().force_value(), p))
                return out

            def write_round(offset, selector, rc_round, next_vals):
                region.enable_selector(selector, offset)
                for i in range(width):
                    region.assign_fixed(
                        config.rc_a[i], offset, config.round_constants[rc_round][i],
                        f"round_{rc_round} rc_{i}",
                    )
                return [
                    region.assign_advice(
                        config.state[i], offset + 1,
                        Value.unknown() if next_vals is None else Value.known(next_vals[i]),
                        f"state_{i}",
                    )
                    for i in range(width)
                ]

            m = config.m_reg
            offset = 0
            round_idx = 0
            for _ in range(config.half_full_rounds):
                v = vals(state)
                nxt = None
                if v is not None:
                    r = [
                        pow((v[i] + config.round_constants[round_idx][i]) % p, 5, p)
                        for i in range(width)
                    ]
                    nxt = [sum(m[i][j] * r[j] for j in range(width)) % p for i in range(width)]
                state = write_round(offset, config.s_full, round_idx, nxt)
                offset += 1
                round_idx += 1

            for _ in range(config.half_partial_rounds):
                v = vals(state)
                region.enable_selector(config.s_partial, offset)
                for i in range(width):
                    region.assign_fixed(
                        config.rc_a[i], offset, config.round_constants[round_idx][i],
                        f"round_{round_idx} rc_{i}",
                    )
                    region.assign_fixed(
                        config.rc_b[i], offset, config.round_constants[round_idx + 1][i],
                        f"round_{round_idx + 1} rc_{i}",
                    )
                nxt = None
                if v is not None:
                    r = [pow((v[0] + config.round_constants[round_idx][0]) % p, 5, p)] + [
                        (v[i] + config.round_constants[round_idx][i]) % p
                        for i in range(1, width)
                    ]
                    region.assign_advice(
                        config.partial_sbox, offset, Value.known(r[0]),
                        f"round_{round_idx} partial_sbox",
                    )
                    p_mid = [sum(m[i][j] * r[j] for j in range(width)) % p for i in range(width)]
                    r_mid = [
                        pow((p_mid[0] + config.round_constants[round_idx + 1][0]) % p, 5, p)
                    ] + [
                        (p_mid[i] + config.round_constants[round_idx + 1][i]) % p
                        for i in range(1, width)
                    ]
                    nxt = [
                        sum(m[i][j] * r_mid[j] for j in range(width)) % p for i in range(width)
                    ]
                else:
                    region.assign_advice(
                        config.partial_sbox, offset, Value.unknown(),
                        f"round_{round_idx} partial_sbox",
                    )
                state = [
                    region.assign_advice(
                        config.state[i], offset + 1,
                        Value.unknown() if nxt is None else Value.known(nxt[i]),
                        f"state_{i}",
                    )
                    for i in range(width)
                ]
                offset += 1
                round_idx += 2

            for _ in range(config.half_full_rounds):
                v = vals(state)
                nxt = None
                if v is not None:
                    r = [
                        pow((v[i] + config.round_constants[round_idx][i]) % p, 5, p)
                        for i in range(width)
                    ]
                    nxt = [sum(m[i][j] * r[j] for j in range(width)) % p for i in range(width)]
                state = write_round(offset, config.s_full, round_idx, nxt)
                offset += 1
                round_idx += 1
            return state

        return layouter.assign_region("permute state", in_region)

    # ---- PoseidonSpongeInstructions ----
    def initial_state(self, layouter: Layouter, domain: ConstantLength) -> List[AssignedCell]:
        config = self.config
        width = config.spec.T
        rate = config.spec.RATE

        def in_region(region: Region):
            state = []
            for i in range(rate):
                state.append(
                    region.assign_advice_from_constant(config.state[i], 0, 0, f"state_{i}")
                )
            state.append(
                region.assign_advice_from_constant(
                    config.state[rate], 0, domain.initial_capacity_element(),
                    f"state_{rate}",
                )
            )
            return state

        return layouter.assign_region(f"initial state for domain {domain.name()}", in_region)

    def add_input(self, layouter: Layouter, initial_state: List[AssignedCell],
                  input_words: List, domain: ConstantLength) -> List[AssignedCell]:
        """input_words: list of RATE entries, each an AssignedCell (message)
        or a plain int (padding, loaded via fixed rc_b scratch)."""
        config = self.config
        width = config.spec.T
        rate = config.spec.RATE
        p = config.spec.FIELD.MODULUS

        def in_region(region: Region):
            region.enable_selector(config.s_pad_and_add, 1)
            loaded = [
                initial_state[i].copy_advice(region, config.state[i], 0, f"load state_{i}")
                for i in range(width)
            ]
            inputs = []
            for i in range(rate):
                word = input_words[i]
                if isinstance(word, AssignedCell):
                    inputs.append(word.copy_advice(region, config.state[i], 1, f"load input_{i}"))
                else:
                    pad = region.assign_fixed(config.rc_b[i], 1, int(word), f"load pad_{i}")
                    inputs.append(pad.copy_advice(region, config.state[i], 1, f"load input_{i}"))
            out = []
            for i in range(width):
                a = loaded[i].value()
                b = inputs[i].value() if i < rate else Value.known(0)
                if a.is_none() or b.is_none():
                    v = Value.unknown()
                else:
                    v = Value.known(
                        (_as_int(a.force_value(), p) + _as_int(b.force_value(), p)) % p
                    )
                out.append(region.assign_advice(config.state[i], 2, v, f"load output_{i}"))
            return out

        return layouter.assign_region(f"add input for domain {domain.name()}", in_region)

    @staticmethod
    def get_output(state: List[AssignedCell], rate: int) -> List[AssignedCell]:
        return list(state[:rate])


class PoseidonHash:
    """Gadget-level constant-length hash driver (poseidon.rs:204-248)."""

    def __init__(self, chip: Pow5Chip, layouter: Layouter, domain: ConstantLength):
        self.chip = chip
        self.domain = domain
        self.state = chip.initial_state(layouter, domain)

    def hash(self, layouter: Layouter, message: Sequence[AssignedCell]) -> AssignedCell:
        assert len(message) == self.domain.L
        rate = self.chip.config.spec.RATE
        padded = list(message) + self.domain.padding(rate)
        for chunk_start in range(0, len(padded), rate):
            chunk = padded[chunk_start : chunk_start + rate]
            self.state = self.chip.add_input(layouter, self.state, chunk, self.domain)
            self.state = self.chip.permute(layouter, self.state)
        return self.chip.get_output(self.state, rate)[0]
