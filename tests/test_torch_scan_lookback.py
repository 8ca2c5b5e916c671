"""Kernels C and E's single-pass scans (csrc/scan.cuh, csrc/scan.cu,
csrc/polyeval.cu) on the host: no JAX, no card.

- `scan.inverse_model`, the kernel's binary-GCD inverse step for step in
  Python integers, equals `pow(x, -1, p)` on the four moduli of
  chip_smoke.py's MODULI, on the edge values (1, 2, p - 1, (p + 1) / 2,
  R mod p, R^-1 mod p, 2^255 mod p, lazy inputs in [p, 2p) and the inputs
  that need the most divsteps a search found) and on random values, within
  its bound of batches; with the product by R^3 it gives the Montgomery
  form of the inverse of a Montgomery value.
- A batch of divsteps on the low 32 bits moves f and g as the same number
  of divsteps on whole integers does.
- The launches' host side: the row tiles and the scratch words at n = 1,
  a tile's rows - 1, + 0 and + 1, 33 tiles and 2^17; b as kernel E's words.
"""

import random

import pytest

from halo2_tpu_torch import fields
from halo2_tpu_torch.ops import polyeval, scan
from halo2_tpu_torch.ops.field import FieldCtx

MODULI = ("Fp", "Fq", "FrBn", "FqBn")
T = scan.TILE_ROWS


def word(w) -> int:
    return sum(v << (32 * i) for i, v in enumerate(w))


def divsteps_to_zero(x: int, p: int) -> int:
    """The divsteps (delta = 1/2 at the start) until g = 0, on whole
    integers."""
    zeta, f, g, steps = -1, p, x, 0
    while g:
        if zeta < 0 and g & 1:
            f, g, zeta = g, (g - f) // 2, -zeta - 2
        else:
            g, zeta = (g + f) // 2 if g & 1 else g // 2, zeta - 1
        steps += 1
    return steps


@pytest.mark.parametrize("name", MODULI)
def test_inverse_model_equals_pow(name):
    p = getattr(fields, name).MODULUS
    rng = random.Random(name)
    edges = scan.inverse_edges(p)
    assert len(scan.HARD_INPUTS[p]) == 2
    assert any(p <= x < 2 * p for x in edges)
    for x in edges + [rng.randrange(1, 2 * p) for _ in range(120)]:
        if x % p == 0:
            continue
        inv, batches = scan.inverse_model(x, p)
        assert inv == pow(x, -1, p), hex(x)
        assert 0 <= inv < p and batches <= scan.INV_BATCHES
    for x in scan.HARD_INPUTS[p]:
        assert divsteps_to_zero(x, p) >= 528
        assert scan.inverse_model(x, p)[1] == 18


@pytest.mark.parametrize("name", MODULI)
def test_r3_turns_the_inverse_into_montgomery_form(name):
    """The kernel inverts the stored x = a R and multiplies by R^3 in a
    Montgomery product (x^-1 R^3 / R): that is a^-1 R."""
    p = getattr(fields, name).MODULUS
    r = (1 << 256) % p
    r3 = word(scan.r3_words(p))
    assert r3 == pow(r, 3, p)
    for a in (1, 2, p - 1, 12345678901234567890):
        x = a * r % p
        inv, _ = scan.inverse_model(x, p)
        assert inv * r3 * pow(r, -1, p) % p == pow(a, -1, p) * r % p


@pytest.mark.parametrize("name", MODULI)
def test_divsteps_batch_moves_f_and_g_as_whole_divsteps(name):
    """The batch's matrix on the low 32 bits gives what INV_STEPS divsteps
    on whole integers give: t [f; g] = 2^30 [f'; g'], and the same zeta."""
    p = getattr(fields, name).MODULUS
    rng = random.Random(name + "steps")
    for _ in range(40):
        f, g, zeta0 = rng.randrange(1, p) | 1, rng.randrange(p), rng.choice([-1, -3, 2, 5])
        zeta, (u, v, q, r) = scan._divsteps(zeta0, f, g)
        nf, ng = u * f + v * g, q * f + r * g
        assert nf % (1 << 30) == 0 and ng % (1 << 30) == 0
        f2, g2, z2 = f, g, zeta0
        for _ in range(scan.INV_STEPS):
            if z2 < 0 and g2 & 1:
                f2, g2, z2 = g2, (g2 - f2) // 2, -z2 - 2
            else:
                g2, z2 = ((g2 + f2) // 2 if g2 & 1 else g2 // 2), z2 - 1
        assert (nf >> 30, ng >> 30, zeta) == (f2, g2, z2)


@pytest.mark.parametrize("n,tiles", [(1, 1), (T - 1, 1), (T, 1), (T + 1, 2), (33 * T, 33), (33 * T + 1, 34),
                                     (1 << 17, (1 << 17) // T)])
def test_tiles_and_scratch(n, tiles):
    assert scan.scan_tiles(n) == tiles
    flags = -(-(tiles + 2) // 4) * 4  # the counter and T + 1 flags, to 16 bytes
    one = flags + (tiles + 1) * 2 * 8
    assert scan.scratch_words(n) == one  # kernel C's scan, kernel E
    assert scan.scratch_words(n, 2) == 2 * one  # batch inversion's two scans
    # the states, and batch inversion's second scan, start on 16 bytes
    assert flags % 4 == 0 and one % 4 == 0
    assert scan.scan_tiles(n) + 1 <= 0x7FFFFFFF


@pytest.mark.parametrize("name", MODULI)
def test_kate_words(name):
    """Kernel E's table of b's powers: b^(2^e) up to a look-back round's
    rows, b^(R l) for 32 lanes, b^(32 R w) for a tile's warps, b^j up to R;
    in Montgomery form, 8 words each."""
    F = getattr(fields, name)
    p, ctx = F.MODULUS, FieldCtx(F)
    rows, warps = scan.SCAN_ROWS, scan.SCAN_THREADS // 32
    log_round = (T * 32 * warps).bit_length() - 1
    for b in (0, 1, p - 1, p + 3, 0x1234_5678_9ABC_DEF0_1234):
        want = ([pow(b, 1 << e, p) for e in range(log_round + 1)] + [pow(b, rows * i, p) for i in range(32)]
                + [pow(b, 32 * rows * w, p) for w in range(warps)] + [pow(b, j, p) for j in range(rows + 1)])
        assert polyeval.kate_powers(b % p, p) == want
        words = list(polyeval.kate_words(ctx, b))
        assert len(words) == 8 * len(want)
        got = [word(words[8 * i:8 * i + 8]) for i in range(len(want))]
        assert got == [v * ctx.r_int % p for v in want]


def test_kernels_per_call():
    assert scan.KERNELS_PER_CALL == {"inclusive": 1, "exclusive": 1, "invert": 2}
    assert scan.TILE_ROWS == scan.SCAN_ROWS * scan.SCAN_THREADS == 256
