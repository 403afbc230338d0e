"""Host-side exact field arithmetic (Python integers).

This is the semantic oracle for every device kernel: prime fields and tower
extensions with the same behavior as libff's Fp_model / Fp2_model / ... /
Fp12_2over3over2_model (libff/algebra/fields/*.tcc), expressed over plain
Python integers.  It is used for:
  * deriving curve constants (Frobenius coefficients, twist constants) that
    libff stores as decimal literals in <curve>_init.cpp,
  * golden values in tests,
  * host-side paths that are not performance critical (sqrt during
    compressed deserialization, parameter generation).

Elements of ``Fp`` are ints in [0, p).  Elements of an extension of degree d
over base B are tuples of d base elements, lowest coefficient first (same
coefficient order as libff's ``coeffs[0..d-1]``).
"""

from __future__ import annotations

import functools
import hashlib

from . import mont


class Fp:
    """Prime field context. Elements are plain ints in [0, p)."""

    degree = 1  # total extension degree over the prime field

    def __init__(self, p: int, bits: int | None = None, name: str = "Fp"):
        self.p = p
        self.name = name
        self.mp = mont.derive(p, bits)

    # -- basic ring ops ----------------------------------------------------
    def zero(self):
        return 0

    def one(self):
        return 1

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def neg(self, a):
        return (-a) % self.p

    def double(self, a):
        return (a + a) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def sqr(self, a):
        return (a * a) % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def pow(self, a, e: int):
        return pow(a, e, self.p)

    def eq(self, a, b):
        return a == b

    def is_zero(self, a):
        return a == 0

    def from_int(self, v: int):
        return v % self.p

    def mul_scalar_int(self, a, k: int):
        return (a * k) % self.p

    # -- squares -----------------------------------------------------------
    def legendre(self, a):
        """1 if QR, -1 if non-residue, 0 if zero."""
        if a % self.p == 0:
            return 0
        return 1 if pow(a, self.mp.euler, self.p) == 1 else -1

    def is_square(self, a):
        return self.legendre(a) >= 0

    def sqrt(self, a):
        """Tonelli-Shanks, same structure as libff fp.tcc:763-812.

        Returns one square root (caller selects parity).  Raises ValueError
        on a non-residue (libff loops forever / asserts in DEBUG).
        """
        p, mp = self.p, self.mp
        a %= p
        if a == 0:
            return 0
        if self.legendre(a) != 1:
            raise ValueError("sqrt of non-residue")
        # find a non-residue deterministically (smallest) for the cofactor
        nqr = self.nqr()
        v = mp.s
        z = pow(nqr, mp.t, p)                  # nqr_to_t
        w = pow(a, mp.t_minus_1_over_2, p)
        x = a * w % p                          # a^((t+1)/2)
        b = x * w % p                          # a^t
        while b != 1:
            m = 0
            b2 = b
            while b2 != 1:
                b2 = b2 * b2 % p
                m += 1
            assert m < v
            w = pow(z, 1 << (v - m - 1), p)
            z = w * w % p
            b = b * z % p
            x = x * w % p
            v = m
        return x

    @functools.lru_cache(maxsize=None)
    def nqr(self):
        n = 2
        while self.legendre(n) != -1:
            n += 1
        return n

    def frobenius(self, a, power: int = 1):
        return a  # x^(p^k) == x in Fp

    # -- components / serialization helpers ---------------------------------
    def component_0(self, a):
        return a

    def coeffs(self, a):
        return (a,)

    def from_coeffs(self, cs):
        (a,) = cs
        return a

    def base(self):
        return self

    # -- Montgomery interop --------------------------------------------------
    def to_mont(self, a):
        return mont.to_mont(self.mp, a)

    def from_mont(self, a):
        return mont.from_mont(self.mp, a)


class Ext:
    """Extension field B[x]/(x^d - non_residue), d in {2, 3}.

    Same tower construction as libff's Fp2_model (fp2.tcc:101-176),
    Fp3_model, Fp6_3over2_model, Fp6_2over3_model, Fp4_model and
    Fp12_2over3over2_model: in every case the defining polynomial is
    x^d = non_residue with non_residue in the base field.
    """

    def __init__(self, base, d: int, non_residue, name: str = "Ext"):
        assert d in (2, 3)
        self.B = base
        self.d = d
        self.nr = non_residue
        self.name = name
        self.degree = base.degree * d
        # the prime field at the bottom of the tower
        f = base
        while not isinstance(f, Fp):
            f = f.B
        self.fp: Fp = f
        self.p = self.fp.p

    # -- basic ring ops ----------------------------------------------------
    def zero(self):
        return tuple(self.B.zero() for _ in range(self.d))

    def one(self):
        return (self.B.one(),) + tuple(self.B.zero() for _ in range(self.d - 1))

    def add(self, a, b):
        return tuple(self.B.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.B.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        return tuple(self.B.neg(x) for x in a)

    def double(self, a):
        return tuple(self.B.double(x) for x in a)

    def mul_by_nr(self, x):
        """Multiply a *base*-field element by the non-residue."""
        return self.B.mul(self.nr, x)

    def mul(self, a, b):
        B, d = self.B, self.d
        if d == 2:
            a0, a1 = a
            b0, b1 = b
            v0 = B.mul(a0, b0)
            v1 = B.mul(a1, b1)
            # (a0+a1)(b0+b1) - v0 - v1
            t = B.mul(B.add(a0, a1), B.add(b0, b1))
            c1 = B.sub(B.sub(t, v0), v1)
            c0 = B.add(v0, self.mul_by_nr(v1))
            return (c0, c1)
        else:
            a0, a1, a2 = a
            b0, b1, b2 = b
            v0 = B.mul(a0, b0)
            v1 = B.mul(a1, b1)
            v2 = B.mul(a2, b2)
            c0 = B.add(v0, self.mul_by_nr(
                B.sub(B.mul(B.add(a1, a2), B.add(b1, b2)), B.add(v1, v2))))
            c1 = B.add(
                B.sub(B.mul(B.add(a0, a1), B.add(b0, b1)), B.add(v0, v1)),
                self.mul_by_nr(v2))
            c2 = B.add(
                B.sub(B.mul(B.add(a0, a2), B.add(b0, b2)), B.add(v0, v2)), v1)
            return (c0, c1, c2)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        B, d = self.B, self.d
        if d == 2:
            # Algorithm 8 of "High-Speed Software Implementation of the
            # Optimal Ate Pairing" (as in fp2.tcc:153-168)
            a0, a1 = a
            t = B.sub(B.sqr(a0), self.mul_by_nr(B.sqr(a1)))
            ti = B.inv(t)
            return (B.mul(a0, ti), B.neg(B.mul(a1, ti)))
        else:
            a0, a1, a2 = a
            t0 = B.sqr(a0)
            t1 = B.sqr(a1)
            t2 = B.sqr(a2)
            t3 = B.mul(a0, a1)
            t4 = B.mul(a0, a2)
            t5 = B.mul(a1, a2)
            c0 = B.sub(t0, self.mul_by_nr(t5))
            c1 = B.sub(self.mul_by_nr(t2), t3)
            c2 = B.sub(t1, t4)
            t6 = B.inv(B.add(B.mul(a0, c0),
                             self.mul_by_nr(B.add(B.mul(a2, c1),
                                                  B.mul(a1, c2)))))
            return (B.mul(t6, c0), B.mul(t6, c1), B.mul(t6, c2))

    def pow(self, a, e: int):
        if e < 0:
            return self.pow(self.inv(a), -e)
        r = self.one()
        for bit in bin(e)[2:]:
            r = self.sqr(r)
            if bit == "1":
                r = self.mul(r, a)
        return r

    def eq(self, a, b):
        return all(self.B.eq(x, y) for x, y in zip(a, b))

    def is_zero(self, a):
        return all(self.B.is_zero(x) for x in a)

    def from_int(self, v: int):
        return (self.B.from_int(v),) + tuple(
            self.B.zero() for _ in range(self.d - 1))

    def mul_scalar_int(self, a, k: int):
        return tuple(self.B.mul_scalar_int(x, k) for x in a)

    def mul_base(self, a, s):
        """Multiply by an element of the immediate base field."""
        return tuple(self.B.mul(x, s) for x in a)

    # -- Frobenius ----------------------------------------------------------
    @functools.lru_cache(maxsize=None)
    def frobenius_coeffs(self):
        """coeffs[j][i] = nr^(i * (p^j - 1) / d) for coefficient i, power j.

        Matches libff's Frobenius_coeffs_c1 (i=1) and _c2 (i=2) tables
        (e.g. alt_bn128_init.cpp:147-205); derived rather than transcribed.
        """
        deg = self.degree
        out = []
        for j in range(deg):
            row = []
            for i in range(self.d):
                e = i * (pow(self.p, j) - 1) // self.d
                row.append(self.B.pow(self.nr, e))
            out.append(tuple(row))
        return tuple(out)

    def frobenius(self, a, power: int = 1):
        """a^(p^power) via coefficient-wise base Frobenius and coeff table."""
        j = power % self.degree
        co = self.frobenius_coeffs()[j]
        return tuple(
            self.B.mul(self.B.frobenius(x, power), co[i])
            for i, x in enumerate(a))

    # -- misc ---------------------------------------------------------------
    def conjugate(self, a):
        """Only for d == 2: (a0, -a1). libff unitary_inverse."""
        assert self.d == 2
        return (a[0], self.B.neg(a[1]))

    unitary_inverse = conjugate

    # -- cyclotomic-subgroup / sparse GT ops (gt_ops.py; the reference's
    # per-class hand-tuned specializations, fp12_2over3over2.tcc:209-425,
    # fp4.tcc:113-231, fp6_2over3.tcc:115-300) --------------------------------
    def cyclotomic_squared(self, a):
        from ..fields import gt_ops
        return gt_ops.cyclotomic_squared(self, a)

    def cyclotomic_exp(self, a, e: int):
        from ..fields import gt_ops
        return gt_ops.cyclotomic_exp(self, a, e)

    def mul_by_024(self, a, ell_0, ell_VW, ell_VV):
        from ..fields import gt_ops
        return gt_ops.fq12_mul_by_024(self, a, ell_0, ell_VW, ell_VV)

    def mul_by_045(self, a, ell_0, ell_VW, ell_VV):
        from ..fields import gt_ops
        return gt_ops.fq12_mul_by_045(self, a, ell_0, ell_VW, ell_VV)

    def mul_by_023(self, a, other):
        from ..fields import gt_ops
        return gt_ops.fq4_mul_by_023(self, a, other)

    def mul_by_2345(self, a, other):
        from ..fields import gt_ops
        return gt_ops.fq6_2over3_mul_by_2345(self, a, other)

    def component_0(self, a):
        return self.B.component_0(a[0])

    def coeffs(self, a):
        return a

    def from_coeffs(self, cs):
        return tuple(cs)

    def base(self):
        return self.B

    def is_square(self, a):
        # a is a square in F_{p^k} iff a^((p^k - 1)/2) == 1 (k even fields of
        # interest here always have p odd)
        e = (pow(self.p, self.degree) - 1) // 2
        return self.is_zero(a) or self.eq(self.pow(a, e), self.one())

    def two_adic_params(self):
        """(s, t, nqr) with p^degree - 1 = 2^s * t (t odd) and nqr a
        deterministically-chosen quadratic non-residue of this extension —
        the Tonelli-Shanks parameters, shared with the batched device sqrt
        (fields/tower.py generic_sqrt)."""
        if getattr(self, "_two_adic", None) is not None:
            return self._two_adic
        order = pow(self.p, self.degree)
        t = order - 1
        s = 0
        while t % 2 == 0:
            t //= 2
            s += 1
        # deterministic search for a non-residue: try (k, 1, 0, ...) then k
        nqr = None
        k = 0
        while nqr is None:
            base_k = self.from_int(k)
            with_x = tuple(
                self.B.add(c, self.B.one()) if i == 1 else c
                for i, c in enumerate(base_k))
            for cand in (with_x, base_k):
                if not self.is_zero(cand) and not self.is_square(cand):
                    nqr = cand
                    break
            k += 1
        self._two_adic = (s, t, nqr)
        return self._two_adic

    def sqrt(self, a):
        """Generic Tonelli-Shanks over the extension (fp2.tcc:178-228)."""
        if self.is_zero(a):
            return a
        s, t, nqr = self.two_adic_params()
        v = s
        z = self.pow(nqr, t)
        w = self.pow(a, (t - 1) // 2)
        x = self.mul(a, w)
        b = self.mul(x, w)
        one = self.one()
        while not self.eq(b, one):
            m = 0
            b2 = b
            while not self.eq(b2, one):
                b2 = self.sqr(b2)
                m += 1
            w = self.pow(z, 1 << (v - m - 1))
            z = self.sqr(w)
            b = self.mul(b, z)
            x = self.mul(x, w)
            v = m
        return x


# ---------------------------------------------------------------------------
# Deterministic RNG: exact reimplementation of libff's SHA512_rng
# (libff/common/rng.tcc:26-71).
# ---------------------------------------------------------------------------

def sha512_rng(mp: mont.MontParams, idx: int) -> int:
    """Return the *plain* field value of SHA512_rng<FieldT>(idx).

    libff hashes (idx_le64 || iter_le64), takes the first num_limbs 64-bit
    limbs little-endian, clears all bits at or above the modulus MSB
    position, and rejection-samples.
    """
    # position of the modulus MSB within n64*64 bits
    mod = mp.p
    topbit = 64 * mp.n64 - 1
    keep_mask = 0
    bitno = topbit
    while bitno >= 0 and not ((mod >> bitno) & 1):
        bitno -= 1
    # clear all bits strictly above `bitno`... libff clears down to (and
    # including) the first bit where mod.test_bit(bitno) is true? No: it
    # clears while test_bit(bitno) == false, i.e. everything above the MSB.
    mask = (1 << (bitno + 1)) - 1
    iter_ = 0
    while True:
        h = hashlib.sha512(
            idx.to_bytes(8, "little") + iter_.to_bytes(8, "little")).digest()
        val = int.from_bytes(h[: 8 * mp.n64], "little") & mask
        iter_ += 1
        if val < mod:
            return val
