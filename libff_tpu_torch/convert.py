"""Layout conversion between the JAX package's arrays and the port's
tensors.

The JAX package holds a field element array as ``(n16, *batch)`` uint32,
each word one 16-bit limb (libff_tpu/fields/fp.py:3-6), and an Fq2 array
as ``(2, n16, *batch)`` (libff_tpu/fields/tower.py:7-12); the port holds
``(n32, *batch)`` and ``(2, n32, *batch)`` int32, each word one 32-bit
limb, with ``limb32[i] = limb16[2i] | limb16[2i+1] << 16`` along the limb
axis ``el_ndim - 1``.  R is the same (2^(64*n64)), so Montgomery and plain
forms carry over unchanged.  The JAX side is taken and returned as numpy
arrays (``np.asarray`` of a jax array), so this module needs no jax.  The
port's tensors go to the card unless the caller names another device.
"""

from __future__ import annotations

import numpy as np
import torch

from .curves.group import AffinePoint, JacobianPoint, ProjectivePoint


def limbs16_to_32(a, axis: int = 0) -> np.ndarray:
    """uint32 16-bit limbs along `axis` -> half as many 32-bit limbs."""
    a = np.moveaxis(np.asarray(a, dtype=np.uint32), axis, 0)
    if a.shape[0] % 2:
        raise ValueError(f"odd limb count {a.shape[0]}")
    if (a >> 16).any():
        raise ValueError("16-bit limbs expected")
    return np.moveaxis(a[0::2] | (a[1::2] << 16), 0, axis)


def limbs32_to_16(b, axis: int = 0) -> np.ndarray:
    """uint32 32-bit limbs along `axis` -> twice as many 16-bit limbs."""
    b = np.moveaxis(np.asarray(b, dtype=np.uint32), axis, 0)
    out = np.empty((2 * b.shape[0],) + b.shape[1:], dtype=np.uint32)
    out[0::2] = b & 0xFFFF
    out[1::2] = b >> 16
    return np.moveaxis(out, 0, axis)


def field_to_torch(a, device="cuda", el_ndim: int = 1) -> torch.Tensor:
    """A JAX field array (as numpy) -> the port's tensor: (n16, *batch) ->
    (n32, *batch) for a prime field (el_ndim 1), (2, n16, *batch) ->
    (2, n32, *batch) for Fq2 (el_ndim 2).  Every field has n16 >= 4, so a
    leading axis of 2 is an Fq2 array's and is refused with el_ndim 1."""
    a = np.asarray(a)
    if el_ndim not in (1, 2) or (a.shape[0] == 2) != (el_ndim == 2):
        raise ValueError(f"a JAX array of shape {a.shape} is not a field "
                         f"array with el_ndim = {el_ndim}")
    b = np.ascontiguousarray(limbs16_to_32(a, el_ndim - 1))
    return torch.from_numpy(b.view(np.int32)).to(device)


def field_from_torch(t: torch.Tensor, el_ndim: int = 1) -> np.ndarray:
    """The port's field tensor -> a JAX-layout uint32 array."""
    if el_ndim not in (1, 2) or (el_ndim == 2 and t.shape[0] != 2):
        raise ValueError(f"a tensor of shape {tuple(t.shape)} is not a field "
                         f"array with el_ndim = {el_ndim}")
    u = t.detach().cpu().contiguous().numpy().view(np.uint32)
    return limbs32_to_16(u, el_ndim - 1)


def affine_to_torch(A, device="cuda", el_ndim: int = 1) -> AffinePoint:
    """(x, y, inf) in the JAX layout -> the port's AffinePoint."""
    x, y, inf = A
    inf = torch.from_numpy(np.asarray(inf, dtype=bool)).to(device)
    return AffinePoint(field_to_torch(x, device, el_ndim),
                       field_to_torch(y, device, el_ndim), inf)


def affine_from_torch(A: AffinePoint, el_ndim: int = 1):
    """The port's AffinePoint -> (x, y, inf) numpy arrays, JAX layout."""
    return (field_from_torch(A.x, el_ndim), field_from_torch(A.y, el_ndim),
            A.inf.detach().cpu().numpy())


def point_to_torch(P, kind=ProjectivePoint, device="cuda", el_ndim: int = 1):
    """A projective or Jacobian triple in the JAX layout -> `kind`."""
    if kind not in (ProjectivePoint, JacobianPoint):
        raise TypeError(
            f"kind is ProjectivePoint or JacobianPoint, not {kind}")
    return kind(*(field_to_torch(a, device, el_ndim) for a in P))


def point_from_torch(P, el_ndim: int = 1):
    """The port's projective or Jacobian point -> numpy triple, JAX layout."""
    return tuple(field_from_torch(a, el_ndim) for a in P)
