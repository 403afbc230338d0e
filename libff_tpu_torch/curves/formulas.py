"""Curve-group formulas over the generic field API.

One implementation of each EFD formula used by the reference (add-2007-bl,
madd-2007-bl, dbl-2009-l, generalized to coeff_a != 0; cf.
alt_bn128_g1.cpp:149-326), written against the abstract field interface
(mul/sqr/add/sub/double) so the same code serves three interpreters:

  * host oracle fields (exact Python ints) — correctness reference,
  * device array fields — direct XLA graphs (kept for small fixed uses),
  * the formula-VM symbolic fields (vm.FpSym / vm.ExtSym) — the fast path:
    traced once into an instruction table, executed as one lax.scan.

Values are whatever the field view uses (ints / arrays / register tuples).
"""

from __future__ import annotations


def jacobian_dbl(F, x, y, z, a_host=None):
    """dbl-2009-l; zero-safe (Z=0 in -> Z3=0 out).  a_host: host value of
    coeff_a, or None when a == 0 (skips the a*Z^4 term at trace time)."""
    A = F.sqr(x)
    B = F.sqr(y)
    C = F.sqr(B)
    t = F.sub(F.sqr(F.add(x, B)), F.add(A, C))
    D = F.double(t)
    E = F.add(F.double(A), A)
    if a_host is not None:
        z2 = F.sqr(z)
        E = F.add(E, F.mul_small_const(F.sqr(z2), a_host))
    FF = F.sqr(E)
    x3 = F.sub(FF, F.double(D))
    c8 = F.double(F.double(F.double(C)))
    y3 = F.sub(F.mul(E, F.sub(D, x3)), c8)
    z3 = F.double(F.mul(y, z))
    return x3, y3, z3


def jacobian_add_raw(F, x1, y1, z1, x2, y2, z2):
    """add-2007-bl candidate; returns (x3, y3, z3, h, r) where h == 0
    flags x-coincidence and r == 0 flags y-coincidence (the caller resolves
    double/inverse/zero special cases with lane masks)."""
    z1z1 = F.sqr(z1)
    z2z2 = F.sqr(z2)
    u1 = F.mul(x1, z2z2)
    u2 = F.mul(x2, z1z1)
    s1 = F.mul(y1, F.mul(z2, z2z2))
    s2 = F.mul(y2, F.mul(z1, z1z1))
    h = F.sub(u2, u1)
    r = F.double(F.sub(s2, s1))
    i = F.sqr(F.double(h))
    j = F.mul(h, i)
    v = F.mul(u1, i)
    x3 = F.sub(F.sub(F.sqr(r), j), F.double(v))
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.double(F.mul(s1, j)))
    z3 = F.mul(F.sub(F.sqr(F.add(z1, z2)), F.add(z1z1, z2z2)), h)
    return x3, y3, z3, h, r


def jacobian_madd_raw(F, x1, y1, z1, x2, y2):
    """madd-2007-bl candidate (Q affine); returns (x3, y3, z3, h, r)."""
    z1z1 = F.sqr(z1)
    u2 = F.mul(x2, z1z1)
    s2 = F.mul(y2, F.mul(z1, z1z1))
    h = F.sub(u2, x1)
    hh = F.sqr(h)
    i = F.double(F.double(hh))
    j = F.mul(h, i)
    r = F.double(F.sub(s2, y1))
    v = F.mul(x1, i)
    x3 = F.sub(F.sub(F.sqr(r), j), F.double(v))
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.double(F.mul(y1, j)))
    z3 = F.sub(F.sqr(F.add(z1, h)), F.add(z1z1, hh))
    return x3, y3, z3, h, r


def rcb_add_a0(F, X1, Y1, Z1, X2, Y2, Z2, b3_host):
    """Complete homogeneous-projective addition for y^2 = x^3 + b
    (Renes–Costello–Batina 2015, Algorithm 7; 12M + 23a).  Valid for ALL
    inputs in an odd-order subgroup — identity, P == Q, P == -Q — with no
    case analysis, which is what makes the MSM reduction phases pure
    straight-line programs.  b3_host = 3*b."""
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t2 = F.mul(Z1, Z2)
    t3 = F.mul(F.add(X1, Y1), F.add(X2, Y2))
    t3 = F.sub(t3, F.add(t0, t1))
    t4 = F.mul(F.add(Y1, Z1), F.add(Y2, Z2))
    t4 = F.sub(t4, F.add(t1, t2))
    t5 = F.mul(F.add(X1, Z1), F.add(X2, Z2))
    t5 = F.sub(t5, F.add(t0, t2))
    t0 = F.add(F.double(t0), t0)               # 3*X1X2
    t2 = F.mul_small_const(t2, b3_host)        # b3*Z1Z2
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    Y3 = F.mul_small_const(t5, b3_host)        # b3*(X1Z2 + X2Z1)
    X3 = F.sub(F.mul(t3, t1), F.mul(t4, Y3))
    Y3 = F.add(F.mul(t1, Z3), F.mul(Y3, t0))
    Z3 = F.add(F.mul(Z3, t4), F.mul(t0, t3))
    return X3, Y3, Z3


def rcb_madd_a0(F, X1, Y1, Z1, x2, y2, b3_host):
    """Complete mixed addition, a = 0 (RCB15 Algorithm 8; 11M).  Complete
    for all projective P; the affine Q must be finite (callers mask the
    infinity flag outside)."""
    t0 = F.mul(X1, x2)
    t1 = F.mul(Y1, y2)
    t3 = F.mul(F.add(x2, y2), F.add(X1, Y1))
    t3 = F.sub(t3, F.add(t0, t1))
    t4 = F.add(F.mul(x2, Z1), X1)              # X1 + x2*Z1
    t5 = F.add(F.mul(y2, Z1), Y1)              # Y1 + y2*Z1
    t0 = F.add(F.double(t0), t0)
    t2 = F.mul_small_const(Z1, b3_host)
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    Y3 = F.mul_small_const(t4, b3_host)
    X3 = F.sub(F.mul(t3, t1), F.mul(t5, Y3))
    Y3 = F.add(F.mul(t1, Z3), F.mul(Y3, t0))
    Z3 = F.add(F.mul(Z3, t5), F.mul(t0, t3))
    return X3, Y3, Z3


def rcb_dbl_a0(F, X, Y, Z, b3_host):
    """Complete doubling, a = 0 (RCB15 Algorithm 9; 6M + 2S)."""
    t0 = F.sqr(Y)
    Z3 = F.double(F.double(F.double(t0)))      # 8*Y^2
    t1 = F.mul(Y, Z)
    t2 = F.mul_small_const(F.sqr(Z), b3_host)  # b3*Z^2
    X3 = F.mul(t2, Z3)
    Y3 = F.add(t0, t2)
    Z3 = F.mul(t1, Z3)
    t1 = F.double(t2)
    t2 = F.add(t1, t2)
    t0 = F.sub(t0, t2)
    Y3 = F.add(F.mul(t0, Y3), X3)
    X3 = F.double(F.mul(t0, F.mul(X, Y)))
    return X3, Y3, Z3


def curve_rhs(F, x, z, a_host, b_host):
    """x^3 + a x z^4 + b z^6 (the Jacobian curve equation RHS)."""
    x3 = F.mul(F.sqr(x), x)
    z2 = F.sqr(z)
    z3 = F.mul(z2, z)
    z6 = F.sqr(z3)
    rhs = F.add(x3, F.mul_small_const(z6, b_host))
    if a_host is not None:
        z4 = F.sqr(z2)
        rhs = F.add(rhs, F.mul(F.mul_small_const(z4, a_host), x))
    return rhs
