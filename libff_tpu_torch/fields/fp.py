"""Batched prime-field arithmetic on CUDA tensors (port of
libff_tpu/fields/fp.py).

An element array has shape ``(n32, *batch)``: ``n32`` 32-bit limbs,
little-endian, limb axis first, stored as ``torch.int32`` holding the
uint32 bit pattern.  Values are in Montgomery form with the JAX package's
R = 2^(64*n64) = 2^(32*n32) and canonically reduced (< p), so the port's
limbs are the JAX package's 16-bit limbs repacked in pairs
(``convert.py``).

On a CUDA tensor, ``add``/``sub``/``mul`` launch kernel K1e
(``csrc/fp_ops.cu``, built on ``csrc/fp.cuh``), and ``inv`` launches its
inverse entry K1e inv once, whatever the batch: the whole ladder of
``pow_static`` runs in each thread's registers.  The kernels are built
for 8 limbs (alt_bn128), 12 (BLS12-381 and BLS12-377) and 24 (BW6-761),
each width from its own source (``csrc/fp_ops_n12.cu``,
``csrc/fp_ops_n24.cu``; ``KERNEL_WIDTHS``).  On a CPU tensor they run
the plain version, :class:`PlainField`, which follows the JAX package's
16-bit CIOS (fp.py:246-276) in int64 tensors: this torch build has no CPU
right shift for uint32, and a 32x32-bit product wraps int64.  The plain
version runs on any device, which is how the card's kernels are checked
against it.  It also has the JAX package's two other in-kernel Montgomery
products, SOS and SOS with block-2 reduction (fp.py:278-375), which
``MsmConfig.kmul`` chooses for the insert and merge kernels (``KMULS``).

:class:`FieldBase` holds what the prime field and the Fq2 tower
(``tower.py``) share: predicates, select, pow_static and the batch
inverse, written over the element dims ``el_ndim``; :func:`ladder` is
pow_static's chain, which the plain versions of the inverses share.  The
host-conversion entry points (``const``, ``from_ints``,
``plain_from_ints``) put their tensors on the card unless the caller
names another device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..host import mont as hm

MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF
# the in-kernel Montgomery products (pallas_insert.py:96-99, fp.cuh)
KMULS = ("cios", "sos", "sos2")
# the limb counts the kernels are built for: 254-bit fields (alt_bn128),
# 377- and 381-bit ones (BLS12-377, BLS12-381) and 761-bit ones (BW6-761)
KERNEL_WIDTHS = (8, 12, 24)


# -- the n16 <-> n32 repack --------------------------------------------------

def to16(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """int32 array with its 32-bit limb axis at `axis` -> int64 array of
    twice as many 16-bit limbs there (axis 1 of an Fq2 array (2, n32,
    *batch))."""
    u = as_u32(x)
    shape = tuple(x.shape)
    return torch.stack([u & MASK16, u >> 16], dim=axis + 1).reshape(
        shape[:axis] + (2 * shape[axis],) + shape[axis + 1:])


def to32(y: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """int64 16-bit limbs at `axis` -> int32 array of half as many 32-bit
    limbs there."""
    shape = tuple(y.shape)
    y = y.reshape(shape[:axis] + (shape[axis] // 2, 2) + shape[axis + 1:])
    return as_int32(y.select(axis + 1, 0) | (y.select(axis + 1, 1) << 16))


def as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values below 2^32 -> the int32 tensor of their bit patterns."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values below 2^32."""
    return x.to(torch.int64) & MASK32


def ints_to_limbs(vals, n32: int) -> np.ndarray:
    """Host ints (each < 2^(32*n32)) -> (n32, N) uint32 numpy limbs."""
    raw = b"".join(int(v).to_bytes(4 * n32, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u4").reshape(len(vals), n32).T.copy()


def limbs_to_ints(a: np.ndarray) -> list[int]:
    """(n32, N) uint32 numpy limbs -> host ints."""
    raw = np.ascontiguousarray(a.T.astype("<u4")).tobytes()
    w = 4 * a.shape[0]
    return [int.from_bytes(raw[i:i + w], "little")
            for i in range(0, len(raw), w)]


def _col(limbs, ndim: int, like: torch.Tensor) -> torch.Tensor:
    """Host limb list -> int64 tensor (n, 1, ..., 1) on like's device."""
    return torch.tensor(limbs, dtype=torch.int64, device=like.device).reshape(
        (len(limbs),) + (1,) * (ndim - 1))


def _carry(t: torch.Tensor):
    """Propagate the carries of relaxed limbs t (n, *batch) int64, entries
    of either sign: returns canonical 16-bit limbs and the signed carry out
    of the top limb.  One pass per link of the longest carry run."""
    out = torch.zeros_like(t[0])
    while True:
        c = t >> 16                        # floor: a borrow comes out as -1
        if not bool(c.any()):
            return t, out
        t = t & MASK16
        t[1:] += c[:-1]
        out = out + c[-1]


def _mul_small_const(F, a, c: int, big):
    """a * c for a host constant (fp.py:118-141): an addition chain when c
    or -c is at most 64, else one Montgomery product with big(c)."""
    c %= F.p
    if c == 0:
        return torch.zeros_like(a)
    neg = F.p - c <= 64
    k = F.p - c if neg else c
    if k > 64:
        return F.mul(a, big(c))
    acc = None
    for bit in bin(k)[2:]:
        acc = F.double(acc) if acc is not None else None
        if bit == "1":
            acc = a if acc is None else F.add(acc, a)
    return F.neg(acc) if neg else acc


def check_kmul(kmul: str) -> None:
    """Raise unless kmul names one of the Montgomery products (KMULS)."""
    if kmul not in KMULS:
        raise ValueError(f"unknown Montgomery product {kmul!r}; one of "
                         f"{KMULS}")


def mul_lo32(x: torch.Tensor, y) -> torch.Tensor:
    """(x * y) mod 2^32 of int64 tensors holding values below 2^32, by
    16-bit halves of x: the full product would wrap int64."""
    return ((x & MASK16) * y + ((((x >> 16) * (y & MASK16)) & MASK16) << 16)
            ) & MASK32


def mul_hi32(x: torch.Tensor, y) -> torch.Tensor:
    """floor(x * y / 2^32) of int64 tensors holding values below 2^32."""
    xl, xh, yl, yh = x & MASK16, x >> 16, y & MASK16, y >> 16
    mid = xl * yh + xh * yl + ((xl * yl) >> 16)
    return xh * yh + (mid >> 16)


class PlainField:
    """The plain version of kernel K1: Montgomery arithmetic on (n16,
    *batch) int64 tensors of 16-bit limbs, on any device.  Same canonical
    residues as fields/fp.py's ``_cios``, ``mul_sos`` and ``mul_sos2`` (a
    canonical residue is unique), with the limb carries deferred, which
    int64 columns hold (each column sums at most 2n products below 2^32).
    ``kmul`` names the Montgomery product that ``mul`` runs
    (:data:`KMULS`); :meth:`with_kmul` gives the same field over another."""

    def __init__(self, p: int, bits: int | None = None, kmul: str = "cios"):
        check_kmul(kmul)
        self.mp = hm.derive(p, bits)
        self.p = p
        self.n = self.mp.n16
        if kmul == "sos2" and self.n % 2:
            raise ValueError("the block-2 reduction needs an even limb count")
        self.kmul = kmul
        self.inv16 = self.mp.inv16
        self._p = hm.int_to_limbs(p, self.n)
        self._p_cols = {}

    def with_kmul(self, kmul: str) -> "PlainField":
        """This field with `kmul` as the product behind ``mul``."""
        if kmul == self.kmul:
            return self
        return PlainField(self.p, self.mp.bits, kmul)

    def _p_col(self, like: torch.Tensor) -> torch.Tensor:
        """p's limbs as _col gives them for `like`, made once per device
        and rank (as are mul_small_const's constants): on the card each
        would be a host-to-device copy, which waits for the stream."""
        key = (like.device, like.ndim)
        col = self._p_cols.get(key)
        if col is None:
            col = self._p_cols[key] = _col(self._p, like.ndim, like)
        return col

    def add(self, a, b):
        # a + b and a + b - p carried in one pass; keep the difference
        # unless it went negative
        u = a + b
        r, out = _carry(torch.stack([u, u - self._p_col(u)], 1))
        return torch.where((out[1] >= 0)[None], r[:, 1], r[:, 0])

    def sub(self, a, b):
        # a - b and a - b + p carried in one pass; keep the first unless it
        # went negative
        v = a - b
        r, out = _carry(torch.stack([v, v + self._p_col(v)], 1))
        return torch.where((out[0] >= 0)[None], r[:, 0], r[:, 1])

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p, canonical, by ``kmul``."""
        return getattr(self, f"mul_{self.kmul}")(a, b)

    def _columns(self, b, extra: int) -> torch.Tensor:
        """Zeroed int64 columns (2n + extra, *batch) on b's device."""
        return torch.zeros((2 * self.n + extra,) + tuple(b.shape[1:]),
                           dtype=torch.int64, device=b.device)

    def _reduced(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """Relaxed columns t (n + 1 of them) of a value below 2p -> its
        canonical residue: carried, then p subtracted unless it borrows."""
        n = self.n
        t, _ = _carry(t)                       # t[n] is 0 or 1
        d, brw = _carry(t[:n] - p)
        return torch.where((t[n] + brw >= 0)[None], d, t[:n])

    def mul_cios(self, a, b):
        """CIOS (fp.py:246-276): per limb of a, the row a_i * b, then the
        reduction step of the row's quotient."""
        a, b = torch.broadcast_tensors(a, b)
        n = self.n
        p = self._p_col(b)
        # column k of a*b + m*p at t[k]; round i zeroes column i mod 2^16
        # and carries it into column i + 1, so t[n:] ends as the product
        # times 2^(-16n), below 2p, in relaxed limbs
        # (a row's product and quotient each one addcmul_: the plain
        # checks on the card are bound by the launches of this loop; the
        # columns stay below 2^40, so t_i inv16 fits int64 unmasked)
        t = self._columns(b, 1)
        for i in range(n):
            t[i:i + n].addcmul_(a[i], b)
            m = (t[i] * self.inv16) & MASK16
            t[i:i + n].addcmul_(m, p)
            t[i + 1] += t[i] >> 16
        return self._reduced(t[n:], p)

    def mul_sos(self, a, b):
        """SOS (fp.py:278-327): the product's columns first, all rows
        independent, then n serial reduction steps of one 16-bit quotient
        each; column i is exact mod 2^16 when step i reads it, because
        carries only move up."""
        a, b = torch.broadcast_tensors(a, b)
        n = self.n
        p = self._p_col(b)
        t = self._columns(b, 1)
        for i in range(n):
            t[i:i + n] += a[i] * b
        for i in range(n):
            m = ((t[i] & MASK16) * self.inv16) & MASK16
            t[i:i + n] += m * p
            t[i + 1] += t[i] >> 16
        return self._reduced(t[n:], p)

    def mul_sos2(self, a, b):
        """SOS with block-2 reduction (fp.py:329-375): n/2 waves, each
        retiring two 16-bit columns with the 32-bit quotient m = t_low32 *
        (-p^-1 mod 2^32), t_low32 the exact low 32 bits of the relaxed
        columns from column i up."""
        a, b = torch.broadcast_tensors(a, b)
        n = self.n
        p = self._p_col(b)
        inv32 = self.mp.inv64 & MASK32
        t = self._columns(b, 2)
        for i in range(n):
            t[i:i + n] += a[i] * b
        for i in range(0, n, 2):
            m = mul_lo32((t[i] + (t[i + 1] << 16)) & MASK32, inv32)
            t[i:i + n] += (m & MASK16) * p
            t[i + 1:i + 1 + n] += (m >> 16) * p
            # both columns are 0 mod 2^16 now: their joint carry moves up
            t[i + 2] += (t[i + 1] + (t[i] >> 16)) >> 16
        return self._reduced(t[n:2 * n + 1], p)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_small_const(self, a, c: int):
        def big(c):
            key = (c, a.device, a.ndim)
            col = self._p_cols.get(key)
            if col is None:
                cm = hm.int_to_limbs(hm.to_mont(self.mp, c), self.n)
                col = self._p_cols[key] = _col(cm, a.ndim, a)
            return col.expand_as(a)

        return _mul_small_const(self, a, c, big)


# -- kernel K1e ---------------------------------------------------------------

_K1E_ARGS = [_build.VP, _build.VP, _build.VP, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, _build.U32P, ctypes.c_uint32, ctypes.c_int,
             _build.VP]


def check_operands(F, a: torch.Tensor, b: torch.Tensor) -> None:
    """Equal-shape int32 element arrays of field F on one device."""
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"operands differ: {tuple(a.shape)} on {a.device} "
                         f"vs {tuple(b.shape)} on {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("field arrays are torch.int32")
    if tuple(a.shape[:F.el_ndim]) != F.el_shape:
        raise ValueError(f"element dims of {tuple(a.shape)} are not "
                         f"{F.el_shape}")


def kernel_device(a: torch.Tensor, n32: int, what: str) -> bool:
    """False for a CPU tensor (the caller runs the plain version), True for
    a CUDA tensor of a width the kernels are built for (KERNEL_WIDTHS);
    raises otherwise."""
    if a.device.type == "cpu":
        return False
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if n32 not in KERNEL_WIDTHS:
        raise NotImplementedError(
            f"{what} is built for 8, 12 and 24 limbs, not n32 = {n32}: "
            "other widths (MNT4/MNT6's 10) wait for ROADMAP Queue 1 item 10")
    return True


def launch_k1e(B: "PrimeField", op: str, a: torch.Tensor, b: torch.Tensor,
               groups: int = 1) -> torch.Tensor:
    """Kernel K1e over equal-shape CUDA arrays that hold `groups` (n32, N)
    limb-major base-field arrays one after another: one for an Fp array
    (n32, *batch), two for an Fq2 array (2, n32, *batch), whose add and
    sub act coefficient-wise."""
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // (groups * B.n32)
    name = _build.width_name("K1e", B.n32)
    fn = _build.function(_build.width_stem("fp_ops", B.n32), f"fp_{op}",
                         _K1E_ARGS)
    _build.launch(fn, f"{name} fp_{op}", a.device, _build.ptr(out),
                  _build.ptr(a), _build.ptr(b), n, groups, B.n32, B.p_c,
                  B.inv32, a.get_device(), _build.stream_ptr(a))
    _build.LAUNCHES[name] += 1
    return out


def fp_op(F: "PrimeField", op: str, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Elementwise a (op) b, op in add/sub/mul, over equal-shape (n32,
    *batch) int32 arrays.  A CPU tensor takes the plain version; a CUDA
    tensor launches kernel K1e."""
    if op not in ("add", "sub", "mul"):
        raise ValueError(f"unknown field op {op!r}")
    check_operands(F, a, b)
    if not kernel_device(a, F.n32, "K1e"):
        return fp_op_plain(F, op, a, b)
    return launch_k1e(F, op, a, b)


def fp_op_plain(F: "PrimeField", op: str, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The plain version of K1e, on any device."""
    return to32(getattr(F.plain, op)(to16(a), to16(b)))


# -- kernel K1e inv, the Fermat inverse --------------------------------------

_INV_ARGS = [_build.VP, _build.VP, ctypes.c_longlong, ctypes.c_int,
             _build.U32P, ctypes.c_uint32, _build.U32P, ctypes.c_int,
             ctypes.c_int, _build.VP]
# fq2_inv's: the Fq2's non-residue after n32
_INV2_ARGS = _INV_ARGS[:4] + [ctypes.c_int] + _INV_ARGS[4:]


def ladder(sqr, mul, a, e: int):
    """a^e for a host exponent e >= 1, square-and-multiply msb first
    (fp.py:447-463; squarings of the leading one are skipped) with the
    given squaring and product: the chain that fp.cuh's pow_ladder runs
    in K1e inv and K4e inv."""
    acc = a
    for bit in bin(e)[3:]:
        acc = sqr(acc)
        if bit == "1":
            acc = mul(acc, a)
    return acc


def ladder_products(e: int) -> int:
    """The products of :func:`ladder` for exponent e, each dependent on
    the one before: a squaring for every bit below the leading one, a
    product for every set bit among them (362 for alt_bn128's p - 2)."""
    return e.bit_length() - 1 + bin(e).count("1") - 1


def window_products(e: int, widths=range(1, 9)) -> int:
    """The products of the shortest left-to-right sliding-window chain for
    a^e over the given window widths: for width w, a^2 and the odd powers
    a^3 .. a^(2^w - 1) first, then a squaring a bit and a product a
    window.  Width 1 is :func:`ladder`'s chain.  The bounds of K1e inv,
    K4e inv and K7e's lane_inv count these, not the ladder's products."""
    bits = bin(e)[2:]
    best = None
    for w in widths:
        n = 1 << (w - 1) if w > 1 else 0
        i, first = 0, True
        while i < len(bits):
            if bits[i] == "0":
                n, i = n + 1, i + 1
                continue
            j = min(i + w, len(bits)) - 1
            while bits[j] == "0":
                j -= 1
            n += 0 if first else j - i + 2
            first, i = False, j + 1
        best = n if best is None else min(best, n)
    return best


def launch_inv(B: "PrimeField", entry: str, name: str, a: torch.Tensor,
               nr: int | None = None) -> torch.Tensor:
    """One launch of K1e inv (entry "fp_inv", a an Fp array) or K4e inv
    ("fq2_inv", a an Fq2 array over Fq[u]/(u^2 - nr), nr given as nr - p)
    over the CUDA array a, with B's p - 2 as the exponent; counted as
    `name`."""
    a = a.contiguous()
    out = torch.empty_like(a)
    fq2 = entry == "fq2_inv"
    fn = _build.function(_build.width_stem("fp_ops", B.n32), entry,
                         _INV2_ARGS if fq2 else _INV_ARGS)
    _build.launch(fn, name, a.device, _build.ptr(out), _build.ptr(a),
                  a.numel() // (B.n32 * (2 if fq2 else 1)), B.n32,
                  *((nr,) if fq2 else ()), B.p_c, B.inv32, B.inv_exp_c,
                  B.inv_exp_top, a.get_device(), _build.stream_ptr(a))
    _build.LAUNCHES[name] += 1
    return out


def fp_inv(F: "PrimeField", a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) of every element of the (n32, *batch) int32 array a; 0 maps
    to 0.  A CPU tensor takes pow_static, the plain version; a CUDA tensor
    launches kernel K1e inv once (counted as "K1e inv", or "K1e inv n12"
    and "K1e inv n24" at 12 and 24 limbs)."""
    check_operands(F, a, a)
    if not kernel_device(a, F.n32, "K1e inv"):
        return F.pow_static(a, F.p - 2)
    return launch_inv(F, "fp_inv", _build.width_name("K1e inv", F.n32), a)


def fp_inv_plain(F: "PrimeField", a: torch.Tensor) -> torch.Tensor:
    """The plain version of K1e inv, on any device: pow_static's ladder on
    the plain field."""
    return to32(ladder(F.plain.sqr, F.plain.mul, to16(a), F.p - 2))


def align(a, b):
    """Broadcast two element arrays whose batch dims trail: pad the
    lower-rank one with trailing singleton dims first (fp.py:43-50)."""
    nd = max(a.ndim, b.ndim)
    a = a.reshape(tuple(a.shape) + (1,) * (nd - a.ndim))
    b = b.reshape(tuple(b.shape) + (1,) * (nd - b.ndim))
    return torch.broadcast_tensors(a, b)


def to_device_tensor(limbs: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy limbs -> an int32 tensor on `device`."""
    return torch.from_numpy(
        np.ascontiguousarray(limbs, dtype=np.uint32).view(np.int32)
    ).to(device)


class FieldBase:
    """What the prime field and the Fq2 tower share, written over the
    element dims ``el_shape`` (``el_ndim`` of them, the 32-bit limb axis
    last): constructors, predicates, select, pow_static and the
    Montgomery-trick batch inverse.  A subclass supplies ``add``, ``sub``,
    ``mul``, ``sqr``, ``inv`` and ``_one_limbs`` (the Montgomery one as
    uint32 limbs of shape ``el_shape``)."""

    el_ndim: int
    el_shape: tuple

    # -- constructors --------------------------------------------------------
    def zero(self, batch=(), device="cuda") -> torch.Tensor:
        return torch.zeros(self.el_shape + tuple(batch), dtype=torch.int32,
                           device=device)

    def one(self, batch=(), device="cuda") -> torch.Tensor:
        o = to_device_tensor(self._one_limbs, device)
        return o.reshape(self.el_shape + (1,) * len(batch)).expand(
            self.el_shape + tuple(batch))

    # -- predicates ----------------------------------------------------------
    def is_zero(self, a):
        return (a == 0).flatten(0, self.el_ndim - 1).all(dim=0)

    def eq(self, a, b):
        # canonical representation => limb-wise equality
        return (a == b).flatten(0, self.el_ndim - 1).all(dim=0)

    def select(self, mask, a, b):
        """where(mask, a, b) with a batch-shaped mask."""
        return torch.where(mask[(None,) * self.el_ndim], a, b)

    # -- derived ops ---------------------------------------------------------
    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def pow_static(self, a, e: int):
        """a^e for a host exponent, square-and-multiply msb first
        (fp.py:447-463; squarings of the leading one are skipped)."""
        if e == 0:
            return self.one(tuple(a.shape[self.el_ndim:]),
                            a.device).contiguous()
        return ladder(self.sqr, self.mul, a, e)

    def _prefix_products(self, x, axis: int):
        """Inclusive prefix products along `axis` in log2(n) rounds."""
        n = x.shape[axis]
        k = 1
        while k < n:
            x = torch.cat([x.narrow(axis, 0, k),
                           self.mul(x.narrow(axis, k, n - k),
                                    x.narrow(axis, 0, n - k))], dim=axis)
            k *= 2
        return x

    def batch_inverse(self, a, axis: int = -1):
        """Montgomery-trick batch inversion along a batch axis
        (fp.py:470-492, tower.py:51-70): prefix and suffix products, one
        inversion.  Zeros pass through as zeros."""
        axis = axis % a.ndim
        if axis < self.el_ndim:
            raise ValueError(f"axis {axis} is an element axis")
        nz = self.is_zero(a).logical_not()[(None,) * self.el_ndim]
        one = self.one(tuple(a.shape[self.el_ndim:]), a.device)
        x = torch.where(nz, a, one)
        pre = self._prefix_products(x, axis)
        suf = self._prefix_products(x.flip(axis), axis).flip(axis)
        n = a.shape[axis]
        total = pre.narrow(axis, n - 1, 1)
        inv_total = self.inv(total.contiguous())
        one1 = one.narrow(axis, 0, 1)
        excl_pre = torch.cat([one1, pre.narrow(axis, 0, n - 1)], dim=axis)
        excl_suf = torch.cat([suf.narrow(axis, 1, n - 1), one1], dim=axis)
        out = self.mul(self.mul(excl_pre, excl_suf), inv_total.expand_as(a))
        return torch.where(nz, out, torch.zeros_like(out))


class PrimeField(FieldBase):
    """Vectorized arithmetic over F_p on (n32, *batch) int32 tensors."""

    el_ndim = 1

    def __init__(self, p: int, bits: int | None = None, name: str = "Fp"):
        self.name = name
        self.mp = hm.derive(p, bits)
        self.p = p
        self.n16 = self.mp.n16
        self.n32 = self.n16 // 2
        self.el_shape = (self.n32,)
        self.inv32 = self.mp.inv64 & 0xFFFFFFFF      # -p^-1 mod 2^32
        self.p_limbs = self._limbs(p)
        self.one_limbs = self._limbs(self.mp.R % p)
        self._one_limbs = np.array(self.one_limbs, dtype=np.uint32)
        self.plain = PlainField(p, bits)
        # host copies handed to the kernels' C entry points
        self.p_c = _build.u32_array(self.p_limbs)
        self.one_c = _build.u32_array(self.one_limbs)
        # the inverses' exponent p - 2 and the index of its leading bit
        self.inv_exp_c = _build.u32_array(self._limbs(p - 2))
        self.inv_exp_top = (p - 2).bit_length() - 1

    @property
    def prime_field(self) -> "PrimeField":
        """The prime field at the bottom of the tower: this one."""
        return self

    def _limbs(self, v: int) -> list[int]:
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(self.n32)]

    def mont_limbs(self, v: int) -> list[int]:
        """The Montgomery form of host int v as n32 limbs."""
        return self._limbs(hm.to_mont(self.mp, v))

    # -- host conversion ----------------------------------------------------
    def const(self, v: int, device="cuda") -> torch.Tensor:
        """Montgomery-form constant, shape (n32,)."""
        return to_device_tensor(np.array(self.mont_limbs(v), dtype=np.uint32),
                                device)

    def from_ints(self, vals, device="cuda") -> torch.Tensor:
        """Host ints -> Montgomery limb array (n32, N) (or (n32,))."""
        if isinstance(vals, int):
            return self.const(vals, device)
        mont = [hm.to_mont(self.mp, int(v)) for v in vals]
        return to_device_tensor(ints_to_limbs(mont, self.n32), device)

    def to_ints(self, x: torch.Tensor) -> list[int]:
        """Montgomery limb array -> host plain ints (batch flattened)."""
        a = x.detach().cpu().reshape(self.n32, -1).numpy().view(np.uint32)
        return [hm.from_mont(self.mp, v) for v in limbs_to_ints(a)]

    def plain_from_ints(self, vals, device="cuda") -> torch.Tensor:
        """Host ints -> plain (non-Montgomery) limb array (n32, N)."""
        if isinstance(vals, int):
            return to_device_tensor(
                np.array(self._limbs(vals % self.p), dtype=np.uint32), device)
        return to_device_tensor(
            ints_to_limbs([int(v) % self.p for v in vals], self.n32), device)

    def plain_to_ints(self, x: torch.Tensor) -> list[int]:
        a = x.detach().cpu().reshape(self.n32, -1).numpy().view(np.uint32)
        return limbs_to_ints(a)

    def to_host(self, x: torch.Tensor) -> int:
        """Unbatched element -> host int, as the Fq2 field's to_host gives
        a host tuple (fields/fp.py:103-107)."""
        (v,) = self.to_ints(x.reshape(self.n32, 1))
        return v

    def from_host(self, v: int, device="cuda") -> torch.Tensor:
        """Host-field element (plain int) -> Montgomery constant (n32,)
        (fields/fp.py:82-84)."""
        return self.const(int(v), device)

    # the names the tower layer shares (fields/fp.py:108-116)
    def from_host_batch(self, vals, device="cuda") -> torch.Tensor:
        """Host ints -> Montgomery array (n32, N)."""
        return self.from_ints([int(v) for v in vals], device)

    def to_host_batch(self, x: torch.Tensor) -> list[int]:
        """Montgomery array -> host ints (batch flattened)."""
        return self.to_ints(x)

    def frobenius(self, a, power: int = 1):
        """The identity on the prime field."""
        return a

    # -- ring ops -----------------------------------------------------------
    def add(self, a, b):
        return fp_op(self, "add", *align(a, b))

    def sub(self, a, b):
        return fp_op(self, "sub", *align(a, b))

    def mul(self, a, b):
        return fp_op(self, "mul", *align(a, b))

    def sqr(self, a):
        return self.mul(a, a)

    def mul_small_const(self, a, c: int):
        return _mul_small_const(
            self, a, c,
            lambda c: self.const(c, a.device).reshape(
                (self.n32,) + (1,) * (a.ndim - 1)).expand_as(a))

    # -- Montgomery domain conversion -----------------------------------------
    def to_mont(self, a_plain):
        """plain limbs -> Montgomery form (times R^2, fp.py:422-426)."""
        r2 = self.plain_from_ints(self.mp.R2, a_plain.device)
        return self.mul(a_plain, r2.reshape(
            (self.n32,) + (1,) * (a_plain.ndim - 1)).expand_as(a_plain))

    def from_mont(self, a):
        """Montgomery form -> plain limbs (times 1, fp.py:428-432)."""
        o = self.plain_from_ints(1, a.device)
        return self.mul(a, o.reshape((self.n32,) + (1,) * (a.ndim - 1))
                        .expand_as(a))

    def inv(self, a):
        """Fermat inverse a^(p-2); maps 0 to 0 (fp.py:465-468).  One K1e
        inv launch on the card (:func:`fp_inv`)."""
        return fp_inv(self, a)
