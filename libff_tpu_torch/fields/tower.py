"""Batched Fq2 arithmetic on CUDA tensors (port of
libff_tpu/fields/tower.py:151 ExtField, degree 2 only).

An element array has shape ``(2, n32, *batch)``: the two coefficients of
a0 + a1*u in Fq[u]/(u^2 - nr), each the prime field's ``(n32, *batch)``
int32 layout, so the port's array is the JAX package's ``(2, n16,
*batch)`` after the limb repack of axis 1 (``convert.py``).

On a CUDA tensor ``add`` and ``sub`` launch kernel K1e on the ``(2*n32,
N)`` view, because they act coefficient-wise, and ``mul`` and ``sqr``
launch kernel K4e (``csrc/fp_ops.cu`` over the Fq2 layer ``csrc/fp2.cuh``,
kernel K4), built for alt_bn128's nr = p - 1; ``inv`` launches K4e inv,
the norm, its Fermat inverse and the two products in one launch.  On a
CPU tensor they run the plain version, :class:`PlainField2`, the JAX
formulas over the prime field's plain version in 16-bit limbs.  Every
result is a canonical residue, so the bits equal the JAX package's.

Degree 3, Frobenius and sqrt wait for a later slice (ROADMAP Queue 1
item 11).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .fp import (FieldBase, PlainField, PrimeField, align, check_operands,
                 kernel_device, ladder, launch_inv, launch_k1e, to16, to32)


class PlainField2:
    """The plain version of kernel K4: Fq2 arithmetic on (2, n16, *batch)
    int64 tensors of 16-bit limbs, on any device.  The values are the JAX
    formulas' (tower.py:211-285); the base-field products of one Fq2 mul
    or sqr go through the plain prime field in one call, stacked on a
    trailing axis, which saves its per-call overhead at small batches.
    They run on B's Montgomery product (``B.kmul``)."""

    def __init__(self, B: PlainField, nr: int):
        self.B = B
        self.nr = nr

    def with_kmul(self, kmul: str) -> "PlainField2":
        """This field with its base products by `kmul` (``KMULS``), as
        ``_KernelField2(F2, kmul)`` runs them (pallas_insert.py:139-160)."""
        B = self.B.with_kmul(kmul)
        return self if B is self.B else PlainField2(B, self.nr)

    def _lin(self, op, a, b):
        # both coefficients in one base-field call: limb axis first
        a, b = torch.broadcast_tensors(a, b)
        return getattr(self.B, op)(a.movedim(0, -1),
                                   b.movedim(0, -1)).movedim(-1, 0)

    def add(self, a, b):
        return self._lin("add", a, b)

    def sub(self, a, b):
        return self._lin("sub", a, b)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def mul_by_nr(self, x):
        """x (a base-field element) times the non-residue."""
        return self.B.mul_small_const(x, self.nr)

    def _products(self, xs, ys):
        """[x * y for x, y in zip(xs, ys)] in one base-field call."""
        r = self.B.mul(torch.stack(xs, -1), torch.stack(ys, -1))
        return r.unbind(-1)

    def mul(self, a, b):
        """Karatsuba (tower.py:250-261)."""
        a, b = torch.broadcast_tensors(a, b)
        B = self.B
        sa, sb = self.add(torch.stack([a[0], b[0]]),
                          torch.stack([a[1], b[1]]))       # a0 + a1, b0 + b1
        v0, v1, t = self._products([a[0], a[1], sa], [b[0], b[1], sb])
        return torch.stack([B.add(v0, self.mul_by_nr(v1)),
                            B.sub(B.sub(t, v0), v1)])

    def sqr(self, a):
        """Complex squaring (tower.py:276-285)."""
        B = self.B
        v, t0 = self._products([a[0], B.add(a[0], a[1])],
                               [a[1], B.add(a[0], self.mul_by_nr(a[1]))])
        return torch.stack([B.sub(B.sub(t0, v), self.mul_by_nr(v)),
                            B.double(v)])

    def mul_small_const(self, a, c):
        return mul_const2(self.B, self.nr, a, c)


def mul_const2(B, nr: int, a, c) -> torch.Tensor:
    """a * c for a host Fq2 constant c = (c0, c1) over base field B (the
    port's or its plain version), coefficient by coefficient with B's
    addition chains or constant products (tower.py:225-243)."""
    outs = []
    for k in (0, 1):
        acc = None
        for i in (0, 1):
            j = (k - i) % 2
            cij = c[j] * nr % B.p if i + j >= 2 else c[j]
            term = B.mul_small_const(a[i], cij)
            acc = term if acc is None else B.add(acc, term)
        outs.append(acc)
    return torch.stack(outs)


# -- kernel K4e --------------------------------------------------------------

_K4E_ARGS = [_build.VP, _build.VP, _build.VP, ctypes.c_longlong, ctypes.c_int,
             _build.U32P, ctypes.c_uint32, ctypes.c_int, _build.VP]


def check_nr(F: "ExtField", what: str) -> None:
    """Raise unless F's non-residue is p - 1, the one K4 is built for."""
    if F.nr != F.B.p - 1:
        raise NotImplementedError(
            f"{what} is built for the non-residue p - 1 (alt_bn128), not "
            f"{F.nr}")


def fq2_op(F: "ExtField", op: str, a: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """Elementwise Fq2 a+b, a-b (ops "add", "sub"), a*b ("mul") or a^2
    ("sqr", b ignored but checked) over equal-shape (2, n32, *batch) int32
    arrays.  A CPU tensor takes the plain version; a CUDA tensor launches
    kernel K1e over both coefficients for add and sub, which act
    coefficient-wise, and kernel K4e for mul and sqr."""
    if op not in ("add", "sub", "mul", "sqr"):
        raise ValueError(f"unknown Fq2 op {op!r}")
    check_operands(F, a, b)
    lin = op in ("add", "sub")
    if not kernel_device(a, F.n32, "K1e" if lin else "K4e"):
        return fq2_op_plain(F, op, a, b)
    if lin:
        return launch_k1e(F.B, op, a, b, groups=2)
    check_nr(F, "K4")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    fn = _build.function("fp_ops", f"fq2_{op}", _K4E_ARGS)
    B = F.B
    _build.launch(fn, f"K4e fq2_{op}", a.device, _build.ptr(out),
                  _build.ptr(a), _build.ptr(b), a.numel() // (2 * B.n32),
                  B.n32, B.p_c, B.inv32, a.get_device(), _build.stream_ptr(a))
    _build.LAUNCHES["K4e"] += 1
    return out


def fq2_op_plain(F: "ExtField", op: str, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """The plain version of K1e and K4e on Fq2 arrays, on any device."""
    if op == "sqr":
        return to32(F.plain.sqr(to16(a, 1)), 1)
    return to32(getattr(F.plain, op)(to16(a, 1), to16(b, 1)), 1)


def inv2(B, mul_by_nr, inv, a):
    """(a0 - a1 u) / (a0^2 - nr a1^2) with one inverse in the base field B
    (tower.py:301-307): B is the port's prime field or its plain version,
    `inv` that field's inverse.  Maps 0 to 0."""
    t = B.sub(B.sqr(a[0]), mul_by_nr(B.sqr(a[1])))
    ti = inv(t)
    return torch.stack([B.mul(a[0], ti), B.neg(B.mul(a[1], ti))])


def fq2_inv(F: "ExtField", a: torch.Tensor) -> torch.Tensor:
    """The inverse of every element of the (2, n32, *batch) int32 array a;
    0 maps to 0.  A CPU tensor takes :func:`inv2` over the port's prime
    field (its inverse pow_static), the plain version; a CUDA tensor
    launches kernel K4e inv once."""
    check_operands(F, a, a)
    if not kernel_device(a, F.n32, "K4e inv"):
        return inv2(F.B, F.mul_by_nr, F.B.inv, a)
    check_nr(F, "K4e inv")
    return launch_inv(F.B, "fq2_inv", "K4e inv", a)


def fq2_inv_plain(F: "ExtField", a: torch.Tensor) -> torch.Tensor:
    """The plain version of K4e inv, on any device: :func:`inv2` over the
    plain prime field, its inverse pow_static's ladder."""
    P = F.plain
    B = P.B
    return to32(inv2(B, P.mul_by_nr,
                     lambda t: ladder(B.sqr, B.mul, t, F.B.p - 2),
                     to16(a, 1)), 1)


class ExtField(FieldBase):
    """Fq2 = B[u]/(u^2 - nr) over a port PrimeField B, on (2, n32, *batch)
    int32 tensors."""

    el_ndim = 2

    def __init__(self, B: PrimeField, host_ext, name: str | None = None):
        """B: the port's base field; host_ext: the host Ext of degree 2 over
        B's prime (for constants)."""
        if host_ext.d != 2 or B.el_ndim != 1:
            raise NotImplementedError(
                "the port's tower has degree 2 over a prime field only; "
                "degree 3 and higher towers wait for ROADMAP Queue 1 item 11")
        self.B = B
        self.name = name or host_ext.name
        self.nr = host_ext.nr % B.p
        self.n32 = B.n32
        self.el_shape = (2, B.n32)
        self._one_limbs = np.array([B.one_limbs, [0] * B.n32],
                                   dtype=np.uint32)
        self.plain = PlainField2(B.plain, self.nr)

    @property
    def prime_field(self) -> PrimeField:
        return self.B

    # -- host conversion ------------------------------------------------------
    def from_host(self, v, device="cuda") -> torch.Tensor:
        """Host tuple (c0, c1) -> Montgomery constant, shape (2, n32)."""
        return torch.stack([self.B.const(int(c), device) for c in v])

    def from_host_batch(self, vals, device="cuda") -> torch.Tensor:
        """Host tuples -> Montgomery array (2, n32, N)."""
        vals = list(vals)
        return torch.stack([self.B.from_ints([int(v[i]) for v in vals],
                                             device) for i in (0, 1)])

    def to_host(self, x: torch.Tensor) -> tuple:
        """Unbatched element (2, n32) -> host tuple."""
        return tuple(self.B.to_host(x[i]) for i in (0, 1))

    def to_host_batch(self, x: torch.Tensor) -> list[tuple]:
        """Batched array -> host tuples (batch flattened)."""
        return list(zip(self.B.to_ints(x[0]), self.B.to_ints(x[1])))

    def mont_limbs(self, v) -> list[int]:
        """The Montgomery limbs of host element v, c0's then c1's."""
        return self.B.mont_limbs(int(v[0])) + self.B.mont_limbs(int(v[1]))

    # -- ring ops ------------------------------------------------------------
    def add(self, a, b):
        return fq2_op(self, "add", *align(a, b))

    def sub(self, a, b):
        return fq2_op(self, "sub", *align(a, b))

    def mul(self, a, b):
        return fq2_op(self, "mul", *align(a, b))

    def sqr(self, a):
        return fq2_op(self, "sqr", a, a)

    def mul_by_nr(self, x):
        """x (a base-field element) times the non-residue."""
        return self.B.mul_small_const(x, self.nr)

    def mul_small_const(self, a, c):
        """a * c for a host Fq2 constant c = (c0, c1) (tower.py:225-243)."""
        return mul_const2(self.B, self.nr, a, c)

    def inv(self, a):
        """(a0 - a1 u) / (a0^2 - nr a1^2) with one base-field Fermat
        inverse (tower.py:301-307); maps 0 to 0.  One K4e inv launch on
        the card (:func:`fq2_inv`)."""
        return fq2_inv(self, a)
