"""Batched short-Weierstrass group arithmetic (port of
libff_tpu/curves/group.py, the part the G1 and G2 MSMs run).

Points are NamedTuples of coordinate arrays ``(*el, *batch)``, ``el`` the
field's element dims: ``(n32,)`` over Fp (G1), ``(2, n32)`` over Fq2
(G2).  Jacobian and projective zero is any point with Z == 0, canonically
(0, 1, 0); affine points carry an explicit infinity mask.  Every batched formula
(``padd``, ``pmadd``, ``pdbl`` and the Jacobian ``add``, ``mixed_add``,
``dbl``) runs through kernel K3 (``group_ops.group_op``) at any batch size:
the JAX package's formula VM, its rounds engine and its size gate are TPU
scheduling and have no counterpart here.  Coordinate maps
(``proj_to_jacobian``, ``to_affine``) are field ops, which run on K1e
(and K4e for the Fq2 products of G2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .group_ops import group_op, tree_width


class JacobianPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class ProjectivePoint(NamedTuple):
    """Homogeneous projective (X : Y : Z); identity (0 : 1 : 0)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class AffinePoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor  # bool mask, batch-shaped


class Group:
    def __init__(self, F, gdef, name: str | None = None):
        """F: the port's PrimeField or Fq2 ExtField; gdef: host GroupDef."""
        self.F = F
        self.gdef = gdef
        self.name = name or gdef.name
        self.order = gdef.order
        self.a_is_zero = gdef.curve.F.is_zero(gdef.curve.a)
        # 3b, the constant of the complete formulas: 9 for alt_bn128 G1,
        # the Fq2 element 3b' for its G2
        self._b3_host = gdef.curve.F.mul_scalar_int(gdef.curve.b, 3)

    @property
    def supports_complete(self) -> bool:
        return self.a_is_zero

    # -- batch plumbing ------------------------------------------------------
    def _batch_of(self, *arrays):
        """Common batch of element arrays; batch dims trail, so shorter ones
        are padded with singletons on the right (group.py:169-176).
        Worked out here: torch.broadcast_shapes imports sympy on its first
        call, seconds of host time in the first MSM."""
        el = self.F.el_ndim
        shapes = [tuple(a.shape[el:]) for a in arrays]
        m = max(len(s) for s in shapes)
        batch = []
        for dims in zip(*[s + (1,) * (m - len(s)) for s in shapes]):
            sizes = set(dims) - {1}
            if len(sizes) > 1:
                raise ValueError(f"batch shapes {shapes} do not broadcast")
            batch.append(sizes.pop() if sizes else 1)
        return tuple(batch)

    def _bc_point(self, P, batch):
        el = self.F.el_ndim

        def bc(a, lead):
            a = a.reshape(tuple(a.shape) + (1,) * (len(batch) + lead - a.ndim))
            return a.expand(tuple(a.shape[:lead]) + tuple(batch))

        if isinstance(P, AffinePoint):
            return AffinePoint(bc(P.x, el), bc(P.y, el), bc(P.inf, 0))
        return type(P)(bc(P.x, el), bc(P.y, el), bc(P.z, el))

    def _op(self, op, points, affine=None):
        """Flatten the batch, run kernel K3, reshape back."""
        arrays = [P.z for P in points] + ([affine.x] if affine else [])
        batch = self._batch_of(*arrays)
        flat = self.F.el_shape + (math.prod(batch),)
        coords, masks = [], []
        for P in points:
            P = self._bc_point(P, batch)
            coords += [c.reshape(flat) for c in P]
        if affine is not None:
            A = self._bc_point(affine, batch)
            coords += [A.x.reshape(flat), A.y.reshape(flat)]
            masks = [A.inf.reshape(flat[-1])]
        outs = group_op(self, op, coords, masks)
        return [o.reshape(self.F.el_shape + batch) for o in outs]

    # -- constructors --------------------------------------------------------
    def proj_zero(self, batch=(), device="cuda") -> ProjectivePoint:
        F = self.F
        return ProjectivePoint(F.zero(batch, device), F.one(batch, device),
                               F.zero(batch, device))

    # -- predicates and maps -------------------------------------------------
    def is_zero(self, P):
        return self.F.is_zero(P.z)

    def select(self, mask, P, Q):
        out = []
        for a, b in zip(P, Q):
            if a.ndim == mask.ndim:      # the bool AffinePoint.inf component
                out.append(torch.where(mask, a, b))
            else:
                out.append(self.F.select(mask, a, b))
        return type(P)(*out)

    def from_affine(self, A: AffinePoint) -> JacobianPoint:
        F = self.F
        batch, dev = tuple(A.inf.shape), A.inf.device
        one, zero = F.one(batch, dev), F.zero(batch, dev)
        return JacobianPoint(F.select(A.inf, zero, A.x),
                             F.select(A.inf, one, A.y),
                             F.select(A.inf, zero, one))

    def proj_from_affine(self, A: AffinePoint) -> ProjectivePoint:
        F = self.F
        batch, dev = tuple(A.inf.shape), A.inf.device
        one, zero = F.one(batch, dev), F.zero(batch, dev)
        return ProjectivePoint(F.select(A.inf, zero, A.x),
                               F.select(A.inf, one, A.y),
                               F.select(A.inf, zero, one))

    def proj_to_jacobian(self, P: ProjectivePoint) -> JacobianPoint:
        """The same group element in Jacobian coordinates: (XZ, YZ^2, Z)."""
        F = self.F
        return JacobianPoint(F.mul(P.x, P.z), F.mul(P.y, F.sqr(P.z)), P.z)

    def to_affine(self, P: JacobianPoint) -> AffinePoint:
        """Affine conversion (group.py:270-286): Fermat inverse for a single
        element, Montgomery-trick batch inversion otherwise.  Zero maps to
        (0, 1, inf=True)."""
        F = self.F
        inf = self.is_zero(P)
        if P.z.ndim == F.el_ndim:
            zinv = F.inv(P.z)
        else:
            zinv = F.batch_inverse(P.z, axis=-1)
        zinv2 = F.sqr(zinv)
        x = F.mul(P.x, zinv2)
        y = F.mul(P.y, F.mul(zinv, zinv2))
        batch, dev = tuple(inf.shape), inf.device
        return AffinePoint(F.select(inf, F.zero(batch, dev), x),
                           F.select(inf, F.one(batch, dev), y), inf)

    # -- batched formulas: kernel K3 -------------------------------------------
    def dbl(self, P: JacobianPoint) -> JacobianPoint:
        """dbl-2009-l; Z = 0 in gives Z = 0 out."""
        return JacobianPoint(*self._op("dbl", [P]))

    def add(self, P: JacobianPoint, Q: JacobianPoint) -> JacobianPoint:
        """add-2007-bl with the P = 0, Q = 0, P = Q, P = -Q masks."""
        return JacobianPoint(*self._op("add", [P, Q]))

    def mixed_add(self, P: JacobianPoint, Q: AffinePoint) -> JacobianPoint:
        """madd-2007-bl with masks; Q may be infinity via its mask."""
        return JacobianPoint(*self._op("madd", [P], affine=Q))

    def padd(self, P: ProjectivePoint, Q: ProjectivePoint) -> ProjectivePoint:
        """Complete projective addition (formulas.rcb_add_a0)."""
        return ProjectivePoint(*self._op("padd", [P, Q]))

    def pmadd(self, P: ProjectivePoint, Q: AffinePoint) -> ProjectivePoint:
        """Complete mixed addition (formulas.rcb_madd_a0); P where Q.inf."""
        return ProjectivePoint(*self._op("pmadd", [P], affine=Q))

    def pdbl(self, P: ProjectivePoint) -> ProjectivePoint:
        """Complete doubling (formulas.rcb_dbl_a0)."""
        return ProjectivePoint(*self._op("pdbl", [P]))

    def proj_sum_tree(self, P: ProjectivePoint, axis: int = -1
                      ) -> ProjectivePoint:
        """Sum along a batch axis by static halving with complete adds,
        padding with the identity (0, 1, 0) to a power of two
        (group.py:536-563)."""
        el = self.F.el_ndim
        axis = axis % P.z.ndim
        if axis < el:
            raise ValueError(f"axis {axis} is an element axis")
        n = P.z.shape[axis]
        m = tree_width(n)
        if m != n:
            pad = list(P.z.shape[el:])
            pad[axis - el] = m - n
            zero = self.proj_zero(tuple(pad), P.z.device)
            P = ProjectivePoint(*(torch.cat([a, z], dim=axis)
                                  for a, z in zip(P, zero)))
        while P.z.shape[axis] > 1:
            half = P.z.shape[axis] // 2
            P = self.padd(ProjectivePoint(*(a.narrow(axis, 0, half) for a in P)),
                          ProjectivePoint(*(a.narrow(axis, half, half)
                                            for a in P)))
        return ProjectivePoint(*(a.squeeze(axis) for a in P))
