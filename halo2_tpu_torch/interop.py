"""Carry the JAX package's data into the port: limb arrays, points, bases.

The "weights" of a proof system are its URS and keys. The tests feed the
JAX package and the port identical inputs through these converters, which
take plain numpy arrays and duck-typed host points (anything with `curve`,
`is_identity()` and `to_bytes_uncompressed()`), so this module imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Type

import numpy as np
import torch

from . import curves, fields
from .ops.field import NLIMBS
from .ops.msm import MSMBases
from .poly import FVec


def limbs_tensor(arr, device="cpu") -> torch.Tensor:
    """(..., 16) limb array of any integer dtype (values < 2^16) -> int32 tensor."""
    arr = np.asarray(arr)
    if arr.shape[-1] != NLIMBS:
        raise ValueError(f"limbs_tensor: last axis must be {NLIMBS}, got {arr.shape}")
    if arr.size and (arr.min() < 0 or arr.max() >= 1 << 16):
        raise ValueError("limbs_tensor: limbs must lie in [0, 2^16)")
    return torch.as_tensor(arr.astype(np.int32), device=device)


def field_of(field) -> Type[fields.FieldElement]:
    """The port's field class of the same name as `field` (a class or a name)."""
    name = field if isinstance(field, str) else field.__name__
    return getattr(fields, name)


def curve_of(curve) -> Type[curves.Curve]:
    """The port's curve class of the same name as `curve` (a class or a name)."""
    name = curve if isinstance(curve, str) else curve.__name__
    return getattr(curves, name)


def fvec(field, arr, device="cpu") -> FVec:
    """Montgomery limb array (n, 16), as the JAX package's `FVec.vals` holds
    it, -> the port's FVec over the field of the same name."""
    return FVec(field_of(field), limbs_tensor(arr, device))


def point(pt) -> curves.Point:
    """A host point of the JAX package -> the same point of the port."""
    curve = curve_of(pt.curve)
    if pt.is_identity():
        return curve.identity()
    return curve.from_bytes_uncompressed(pt.to_bytes_uncompressed())


def msm_bases(curve, points: Sequence, device="cpu") -> MSMBases:
    """Host points of the JAX package -> the port's MSMBases on `device`."""
    return MSMBases(curve_of(curve), [point(pt) for pt in points], device)
