"""Host-side exact elliptic-curve group arithmetic (oracle).

Short-Weierstrass groups y^2 = x^3 + a*x + b over any host field from
``libff_tpu.host.field`` — the semantic reference for the batched Jacobian
device kernels (which follow libff's formula choices, e.g.
alt_bn128_g1.cpp:149-326).  Points here are affine tuples ``(x, y)`` or
``None`` for the identity; correctness, not speed.
"""

from __future__ import annotations


class WeierstrassCurve:
    def __init__(self, F, a, b, name: str = "E"):
        self.F = F
        self.a = a
        self.b = b
        self.name = name

    # points: None == identity, else (x, y) affine
    def is_on_curve(self, P) -> bool:
        if P is None:
            return True
        F = self.F
        x, y = P
        lhs = F.sqr(y)
        rhs = F.add(F.add(F.mul(F.sqr(x), x), F.mul(self.a, x)), self.b)
        return F.eq(lhs, rhs)

    def neg(self, P):
        if P is None:
            return None
        return (P[0], self.F.neg(P[1]))

    def add(self, P, Q):
        F = self.F
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if F.eq(x1, x2):
            if F.eq(y1, y2):
                return self.dbl(P)
            return None
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        return (x3, y3)

    def dbl(self, P):
        F = self.F
        if P is None:
            return None
        x1, y1 = P
        if F.is_zero(y1):
            return None
        num = F.add(F.mul_scalar_int(F.sqr(x1), 3), self.a)
        lam = F.mul(num, F.inv(F.mul_scalar_int(y1, 2)))
        x3 = F.sub(F.sqr(lam), F.mul_scalar_int(x1, 2))
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        return (x3, y3)

    def mul(self, k: int, P):
        if k < 0:
            return self.mul(-k, self.neg(P))
        R = None
        for bit in bin(k)[2:] if k else "":
            R = self.dbl(R)
            if bit == "1":
                R = self.add(R, P)
        return R

    def msm(self, scalars, points):
        R = None
        for k, P in zip(scalars, points):
            R = self.add(R, self.mul(k, P))
        return R

    def y_at_x(self, x):
        """curve_point_y_at_x (curve_utils.tcc:34-46): y = sqrt(x^3+ax+b)."""
        F = self.F
        y2 = F.add(F.add(F.mul(F.sqr(x), x), F.mul(self.a, x)), self.b)
        return F.sqrt(y2)


class EdwardsCurve:
    """Twisted Edwards curve  a*x^2 + y^2 = 1 + d*x^2*y^2  (oracle).

    Affine points are (x, y) tuples; the identity is (0, 1) — no point at
    infinity.  The complete Edwards addition law covers every case for the
    odd-order subgroup the library works in (the device side mirrors
    libff's inverted-Edwards formulas, edwards_g1.cpp:165-273; this oracle
    uses the textbook affine law, which yields the same group)."""

    def __init__(self, F, a, d, name: str = "Ed"):
        self.F = F
        self.a = a
        self.d = d
        self.name = name

    def zero(self):
        return (self.F.zero(), self.F.one())

    def is_zero(self, P):
        F = self.F
        return F.is_zero(P[0]) and F.eq(P[1], F.one())

    def is_on_curve(self, P) -> bool:
        F = self.F
        x, y = P
        x2 = F.sqr(x)
        y2 = F.sqr(y)
        lhs = F.add(F.mul(self.a, x2), y2)
        rhs = F.add(F.one(), F.mul(F.mul(self.d, x2), y2))
        return F.eq(lhs, rhs)

    def neg(self, P):
        return (self.F.neg(P[0]), P[1])

    def add(self, P, Q):
        F = self.F
        x1, y1 = P
        x2, y2 = Q
        x1x2 = F.mul(x1, x2)
        y1y2 = F.mul(y1, y2)
        dxy = F.mul(self.d, F.mul(x1x2, y1y2))
        x3 = F.mul(F.add(F.mul(x1, y2), F.mul(y1, x2)),
                   F.inv(F.add(F.one(), dxy)))
        y3 = F.mul(F.sub(y1y2, F.mul(self.a, x1x2)),
                   F.inv(F.sub(F.one(), dxy)))
        return (x3, y3)

    def dbl(self, P):
        return self.add(P, P)

    def mul(self, k: int, P):
        if k < 0:
            return self.mul(-k, self.neg(P))
        R = self.zero()
        for bit in bin(k)[2:] if k else "":
            R = self.dbl(R)
            if bit == "1":
                R = self.add(R, P)
        return R

    def msm(self, scalars, points):
        R = self.zero()
        for k, P in zip(scalars, points):
            R = self.add(R, self.mul(k, P))
        return R
