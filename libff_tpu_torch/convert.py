"""Layout conversion between the JAX package's arrays and the port's
tensors.

The JAX package holds a field element array as ``(n16, *batch)`` uint32,
each word one 16-bit limb (libff_tpu/fields/fp.py:3-6); the port holds
``(n32, *batch)`` int32, each word one 32-bit limb, with
``limb32[i] = limb16[2i] | limb16[2i+1] << 16``.  R is the same
(2^(64*n64)), so Montgomery and plain forms carry over unchanged.  The
JAX side is taken and returned as numpy arrays (``np.asarray`` of a jax
array), so this module needs no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .curves.group import AffinePoint, JacobianPoint, ProjectivePoint


def limbs16_to_32(a) -> np.ndarray:
    """(n16, *batch) uint32 16-bit limbs -> (n16/2, *batch) uint32."""
    a = np.asarray(a, dtype=np.uint32)
    if a.shape[0] % 2:
        raise ValueError(f"odd limb count {a.shape[0]}")
    if (a >> 16).any():
        raise ValueError("16-bit limbs expected")
    return a[0::2] | (a[1::2] << 16)


def limbs32_to_16(b) -> np.ndarray:
    """(n32, *batch) uint32 -> (2*n32, *batch) uint32 16-bit limbs."""
    b = np.asarray(b, dtype=np.uint32)
    out = np.empty((2 * b.shape[0],) + b.shape[1:], dtype=np.uint32)
    out[0::2] = b & 0xFFFF
    out[1::2] = b >> 16
    return out


def field_to_torch(a, device=None) -> torch.Tensor:
    """A JAX field array (as numpy) -> the port's (n32, *batch) tensor."""
    b = np.ascontiguousarray(limbs16_to_32(a))
    return torch.from_numpy(b.view(np.int32)).to(device)


def field_from_torch(t: torch.Tensor) -> np.ndarray:
    """The port's field tensor -> a JAX-layout (n16, *batch) uint32 array."""
    u = t.detach().cpu().contiguous().numpy().view(np.uint32)
    return limbs32_to_16(u)


def affine_to_torch(A, device=None) -> AffinePoint:
    """(x, y, inf) in the JAX layout -> the port's AffinePoint."""
    x, y, inf = A
    return AffinePoint(field_to_torch(x, device), field_to_torch(y, device),
                       torch.from_numpy(np.asarray(inf, dtype=bool)).to(device))


def affine_from_torch(A: AffinePoint):
    """The port's AffinePoint -> (x, y, inf) numpy arrays, JAX layout."""
    return (field_from_torch(A.x), field_from_torch(A.y),
            A.inf.detach().cpu().numpy())


def point_to_torch(P, kind=ProjectivePoint, device=None):
    """A projective or Jacobian triple in the JAX layout -> `kind`."""
    if kind not in (ProjectivePoint, JacobianPoint):
        raise TypeError(f"kind is ProjectivePoint or JacobianPoint, not {kind}")
    return kind(*(field_to_torch(a, device) for a in P))


def point_from_torch(P):
    """The port's projective or Jacobian point -> numpy triple, JAX layout."""
    return tuple(field_from_torch(a) for a in P)
