"""Prefix-product scans and Montgomery-trick batch inversion on limb tensors.

Counterpart of `halo2_tpu/ops/scan.py`. The JAX package uses
`lax.associative_scan`; here the inclusive prefix product is a Hillis-Steele
scan: log2(n) rounds, each one batched `mont_mul` of the array against
itself shifted by 2^r. Batch inversion needs the inverse of ONE element (the
total product), which is taken on the host with Python's `pow` instead of a
254-step Fermat ladder of single-element tensor ops.

Every result is exact mod p, so it equals the JAX package's after
canonicalisation.
"""

from __future__ import annotations

from typing import Optional

import torch

from .field import FieldCtx, is_zero, mont_mul, select


def prefix_product(vals: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """Inclusive prefix products along axis 0: out[i] = prod_{j<=i} vals[j]."""
    out = vals
    n = vals.shape[0]
    d = 1
    while d < n:
        out = torch.cat([out[:d], mont_mul(out[d:], out[:-d], ctx)], dim=0)
        d *= 2
    return out


def exclusive_prefix_product(
    vals: torch.Tensor, ctx: FieldCtx, init: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """out[i] = init * prod_{j<i} vals[j]  (init defaults to one)."""
    incl = prefix_product(vals, ctx)
    one = ctx.one(vals.device)[None]
    excl = torch.cat([one, incl[:-1]], dim=0)
    if init is not None:
        excl = mont_mul(excl, init, ctx)
    return excl


def batch_invert(vals: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """Invert all n elements with one inversion; zeros pass through as zero."""
    zero_mask = is_zero(vals, ctx)
    one = ctx.one(vals.device).expand_as(vals)
    safe = select(zero_mask, one, vals)
    pre = exclusive_prefix_product(safe, ctx)  # prod_{j<i}
    suf = exclusive_prefix_product(safe.flip(0), ctx).flip(0)  # prod_{j>i}
    total = mont_mul(pre[-1], safe[-1], ctx)
    (t,) = ctx.decode_ints(total)
    total_inv = ctx.const(pow(t, -1, ctx.p_int), vals.device)
    out = mont_mul(mont_mul(pre, suf, ctx), total_inv, ctx)
    return select(zero_mask, torch.zeros_like(vals), out)
