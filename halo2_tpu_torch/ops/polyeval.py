"""Batched polynomial evaluation, Horner fold and Kate division on limb tensors.

Counterpart of `halo2_tpu/ops/polyeval.py`:

  * `batch_eval_mont`: M stacked polynomials at (few) points through a
    log-doubling power ladder and a log-depth modular tree sum.
  * `horner_fold_mont`: fold a stack of polynomials by a scalar.
  * `kate_division_mont`: (p(X) - p(b)) / (X - b). The suffix recurrence
    s_i = a_i + b*s_{i+1} has a constant multiplier, so it is a Hillis-Steele
    scan over the reversed coefficients: round r adds b^(2^r) times the
    array shifted by 2^r.
"""

from __future__ import annotations

from typing import List, Sequence, Type

import torch

from ..fields import FieldElement
from .field import NLIMBS, FieldCtx, add_mod, mont_mul


def device_powers(x_mont: torch.Tensor, n: int, ctx: FieldCtx) -> torch.Tensor:
    """[1, x, ..., x^(n-1)] from a (..., 16) Montgomery scalar by
    log-doubling: pw_{2l} = pw_l ++ (x^l * pw_l)."""
    lead = x_mont.shape[:-1]
    pw = ctx.one(x_mont.device).expand(*lead, 1, NLIMBS)
    xl = x_mont
    length = 1
    while length < n:
        ext = mont_mul(pw, xl.unsqueeze(-2), ctx)
        pw = torch.cat([pw, ext], dim=-2)
        if 2 * length < n:
            xl = mont_mul(xl, xl, ctx)
        length *= 2
    return pw[..., :n, :]


def tree_sum(t: torch.Tensor, ctx: FieldCtx, dim: int) -> torch.Tensor:
    """Log-depth modular sum along `dim`."""
    t = t.movedim(dim, 0)
    while t.shape[0] > 1:
        if t.shape[0] % 2:
            t = torch.cat([t, torch.zeros_like(t[:1])], dim=0)
        half = t.shape[0] // 2
        t = add_mod(t[:half], t[half:], ctx)
    return t[0]


def batch_eval_mont(
    field: Type[FieldElement], coeff_stack: torch.Tensor, points: Sequence[int]
) -> torch.Tensor:
    """Evaluate coeff_stack[i] (Montgomery limbs, coeff basis) at points[i];
    (M, 16) Montgomery results. Distinct points share one power ladder."""
    ctx = FieldCtx(field)
    n = coeff_stack.shape[1]
    dev = coeff_stack.device
    uniq = sorted(set(int(x) % ctx.p_int for x in points))
    index = {x: i for i, x in enumerate(uniq)}
    pws = device_powers(ctx.consts(uniq, dev), n, ctx)  # (Q, n, 16)
    sel = torch.as_tensor([index[int(x) % ctx.p_int] for x in points], device=dev)
    t = mont_mul(coeff_stack, pws[sel], ctx)
    return tree_sum(t, ctx, dim=1)


def batch_eval(
    field: Type[FieldElement], coeff_stack: torch.Tensor, points: Sequence[int]
) -> List[int]:
    """Host-int results of `batch_eval_mont` (one readback)."""
    return FieldCtx(field).decode_ints(batch_eval_mont(field, coeff_stack, points))


def horner_fold_mont(field: Type[FieldElement], stack: torch.Tensor, x: int) -> torch.Tensor:
    """acc = (...(s_0 * x + s_1) * x + ...) + s_{M-1} over (M, n, 16)."""
    ctx = FieldCtx(field)
    xm = ctx.const(x, stack.device)
    acc = stack[0]
    for i in range(1, stack.shape[0]):
        acc = add_mod(mont_mul(acc, xm, ctx), stack[i], ctx)
    return acc


def kate_division_mont(field: Type[FieldElement], coeffs: torch.Tensor, b: int) -> torch.Tensor:
    """(p(X) - p(b)) / (X - b) over (n, 16) Montgomery limbs; returns n limbs
    with the top coefficient zero."""
    ctx = FieldCtx(field)
    n = coeffs.shape[0]
    s = coeffs.flip(0)  # s[t] accumulates sum_{u<=t} r_u b^(t-u)
    bd = ctx.const(b, coeffs.device)
    d = 1
    while d < n:
        s = torch.cat([s[:d], add_mod(s[d:], mont_mul(s[:-d], bd, ctx), ctx)], dim=0)
        d *= 2
        if d < n:
            bd = mont_mul(bd, bd, ctx)
    s = s.flip(0)  # s[i] = sum_{j>=i} a_j b^(j-i)
    return torch.cat([s[1:], torch.zeros_like(s[:1])], dim=0)
