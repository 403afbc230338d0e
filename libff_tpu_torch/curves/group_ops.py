"""Kernel K3: one batched group formula per element (port of
libff_tpu/curves/pallas_ops.py, both branches: G1 over Fp and G2 over
Fq2).

:func:`group_op` takes the arguments of the JAX entry point
(``group_op_pallas``, pallas_ops.py:160): a list of coordinate arrays
``(*el, N)``, ``el`` the field's element dims (``(n32,)`` for Fp, ``(2,
n32)`` for Fq2), and a list of ``(N,)`` bool masks (Q's infinity flag for
the mixed adds), and returns three coordinate arrays.  On a CUDA tensor it
launches ``csrc/group_ops.cu``; on a CPU tensor it runs
:func:`group_op_plain`, which evaluates ``curves/formulas.py`` over the
plain field with the kernel's masks as ``torch.where``.  The TPU kernel's
size gate (``kernel_op_eligible``: N % 1024 == 0 and N >= 2^13) follows the
TPU's tiling; this kernel takes any N.

:func:`horner_scan` is K3's scan entry: the Horner phase of the MSM
(libff_tpu/msm/pippenger.py:419-433, a scan of masked pdbl steps and a sum
tree) as one launch of ``csrc/horner.cu`` on a CUDA tensor, and
:func:`horner_scan_plain`, the same steps over :func:`group_op_plain`, on
a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..fields.fp import _carry, to16, to32
from ..fields.tower import PlainField2
from ..host import mont as hm
from . import formulas as fml

# op -> (its code in csrc/group_ops.cu, coordinate inputs, masks)
OPS = {"padd": (0, 6, 0), "pmadd": (1, 5, 1), "pdbl": (2, 3, 0),
       "add": (3, 6, 0), "madd": (4, 5, 1), "dbl": (5, 3, 0)}
_ARGS = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), _build.VP,
         ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, _build.U32P, _build.U32P, _build.U32P,
         ctypes.c_uint32, ctypes.c_int, _build.VP]
_PTRS3 = ctypes.POINTER(ctypes.c_void_p)
_SCAN_ARGS = [_PTRS3, _PTRS3, _PTRS3, _build.VP, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              _build.U32P, _build.U32P, _build.U32P, ctypes.c_uint32,
              ctypes.c_int, _build.VP]


def kernel_branch(G, what: str):
    """The CUDA kernels' branch for group G as (k, b3, b3's Montgomery
    limbs): k = 1 for alt_bn128 G1 (254-bit Fp, b3 = 9 by an addition
    chain), k = 2 for alt_bn128 G2 (Fq2 with nr = p - 1, b3 a runtime
    constant).  Raises for any other group."""
    F = G.F
    if F.n32 == 8 and F.el_ndim == 1 and G._b3_host == 9:
        return 1, 9, None
    if F.n32 == 8 and F.el_ndim == 2 and F.nr == F.B.p - 1:
        return 2, 0, _build.u32_array(F.mont_limbs(G._b3_host))
    raise NotImplementedError(
        f"{what} is built for alt_bn128 G1 (254-bit Fp, b3 = 9) and G2 "
        f"(Fq2 over a 254-bit Fp with nr = p - 1), not {G.name}")


def _check(G, op, coords, masks):
    if op not in OPS:
        raise ValueError(f"unknown group op {op!r}")
    _, nin, nmask = OPS[op]
    if len(coords) != nin or len(masks) != nmask:
        raise ValueError(f"{op} takes {nin} coordinates and {nmask} masks, "
                         f"got {len(coords)} and {len(masks)}")
    if not G.a_is_zero:
        raise NotImplementedError(
            "group ops for a != 0 curves wait for the non-complete slice "
            "(ROADMAP Queue 1 item 10)")
    shape, dev = coords[0].shape, coords[0].device
    el = G.F.el_shape
    if len(shape) != len(el) + 1 or tuple(shape[:-1]) != el:
        raise ValueError(f"coordinates are {el} + (N,); got {tuple(shape)}")
    for c in coords:
        if c.shape != shape or c.device != dev or c.dtype != torch.int32:
            raise ValueError("coordinates differ in shape, device or dtype")
    for m in masks:
        if m.shape != shape[-1:] or m.device != dev or m.dtype != torch.bool:
            raise ValueError("masks are (N,) bool on the coordinates' device")


def group_op(G, op: str, coords, masks=()):
    """One batched group op over (*el, N) coordinates; returns [X, Y, Z]."""
    coords, masks = list(coords), list(masks)
    _check(G, op, coords, masks)
    dev = coords[0].device
    if dev.type == "cpu":
        return group_op_plain(G, op, coords, masks)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    k, b3, b3_mont = kernel_branch(G, "K3")
    coords = [c.contiguous() for c in coords]
    mask = (masks[0].to(torch.int32).contiguous() if masks else None)
    n = coords[0].shape[-1]
    outs = [torch.empty_like(coords[0]) for _ in range(3)]
    ins = (ctypes.c_void_p * 6)(*([c.data_ptr() for c in coords]
                                  + [None] * (6 - len(coords))))
    ous = (ctypes.c_void_p * 3)(*[o.data_ptr() for o in outs])
    Fp = G.F.prime_field
    fn = _build.function("group_ops", "group_op", _ARGS)
    _build.launch(fn, f"K3 group_op {op} (k = {k})", dev, OPS[op][0], ins,
                  _build.ptr(mask) if mask is not None else None, ous, n,
                  Fp.n32, k, b3, b3_mont, Fp.p_c, Fp.one_c, Fp.inv32,
                  coords[0].get_device(), _build.stream_ptr(coords[0]))
    _build.LAUNCHES[f"K3 g{k}"] += 1
    return outs


def group_op_plain(G, op: str, coords, masks=()):
    """The plain version of K3 on any device: formulas.py over the plain
    field, masks as in pallas_ops.py:88-140."""
    return _group_op_over(G, G.F.plain, op, coords, masks)


def group_op_pair_plain(G, op: str, coords, masks=()):
    """K3's G2 branch as the kernel schedules it, on any device: the same
    formulas over :class:`PairField2`, each Fq2 product as the two lanes'
    lazy sums and one reduction each (csrc/fp2_pair.cuh).  Gives
    group_op_plain's bits, or raises where a lane's sum breaks the bound
    its single reduction needs."""
    F = G.F
    if F.el_ndim != 2 or F.nr != F.B.p - 1:
        raise NotImplementedError(
            "the pair schedule is built for Fq2 with nr = p - 1 (alt_bn128 "
            "G2)")
    return _group_op_over(G, PairField2(F.plain.B), op, coords, masks)


def _group_op_over(G, F, op: str, coords, masks):
    """K3's formulas and masks over the plain field F."""
    coords, masks = list(coords), list(masks)
    _check(G, op, coords, masks)
    ax = G.F.el_ndim - 1                                # the limb axis
    cs = [to16(c, ax) for c in coords]
    b3 = G._b3_host
    el = (None,) * G.F.el_ndim

    def sel(mask, a, b):
        return torch.where(mask[el], a, b)

    def is_zero(v):
        return (v == 0).flatten(0, ax).all(dim=0)

    def one_like(v):
        return to16(G.F.one(tuple(v.shape[ax + 1:]), v.device), ax)

    if op == "pdbl":
        out = fml.rcb_dbl_a0(F, *cs, b3)
    elif op == "padd":
        out = fml.rcb_add_a0(F, *cs, b3)
    elif op == "dbl":
        out = fml.jacobian_dbl(F, *cs, None)
    elif op == "pmadd":
        q_inf = masks[0]
        out = [sel(q_inf, p, r)
               for p, r in zip(cs[:3], fml.rcb_madd_a0(F, *cs, b3))]
    else:
        if op == "add":
            x3, y3, z3, h, r = fml.jacobian_add_raw(F, *cs)
            q_zero = is_zero(cs[5])
            q = cs[3:6]
        else:
            x3, y3, z3, h, r = fml.jacobian_madd_raw(F, *cs)
            q_zero = masks[0]
            q = [cs[3], cs[4], one_like(cs[3])]
        d = fml.jacobian_dbl(F, cs[0], cs[1], cs[2], None)
        p_zero = is_zero(cs[2])
        h_zero, r_zero = is_zero(h), is_zero(r)
        both_live = ~p_zero if op == "madd" else (~p_zero) & (~q_zero)
        dbl_case = h_zero & r_zero & both_live
        inf_case = h_zero & (~r_zero) & both_live
        out = [sel(dbl_case, a, b) for a, b in zip(d, (x3, y3, z3))]
        ident = [torch.zeros_like(x3), one_like(x3), torch.zeros_like(x3)]
        out = [sel(inf_case, a, b) for a, b in zip(ident, out)]
        out = [sel(p_zero, a, b) for a, b in zip(q, out)]
        out = [sel(q_zero, a, b) for a, b in zip(cs[:3], out)]
    return [to32(v, ax) for v in out]


class PairField2(PlainField2):
    """Fq2 (nr = p - 1) on (2, n16, *batch) int64 tensors as the two
    threads of csrc/fp2_pair.cuh compute it: coefficient c of a product is
    lane c's REDC(x0 y0 + x1 y1), with (x0, y0, x1, y1) = (a0, b0, a1, p -
    b1) on lane 0 and (a1, b0, a0, b1) on lane 1, each row of the
    reduction adding both products' row before its quotient (CIOS, in
    16-bit rows where the kernel takes 32-bit ones: the same residue); a
    square is one product a lane, (a0 + a1)(a0 - a1) and a0 (2 a1); the
    product by b3 is the product by its Montgomery constant.  Both lanes
    run as one stacked batch.  Additions are PlainField2's."""

    def __init__(self, B):
        super().__init__(B, B.p - 1)
        self._p = hm.int_to_limbs(B.p, B.n)

    def _redc_of_sums(self, x0, y0, x1, y1):
        """Per lane, REDC(x0 y0 + x1 y1) in relaxed 16-bit columns; raises
        unless the reduced value is below 2p, the bound that one
        conditional subtraction needs."""
        B, n = self.B, self.B.n
        p = torch.tensor(self._p, dtype=torch.int64,
                         device=x0.device).reshape((n,) + (1,) * (x0.ndim - 1))
        t = B._columns(x0, 1)
        for i in range(n):
            t[i:i + n] += x0[i] * y0 + x1[i] * y1
            m = ((t[i] & 0xFFFF) * B.inv16) & 0xFFFF
            t[i:i + n] += m * p
            t[i + 1] += t[i] >> 16
        r = t[n:]
        v, top = _carry(r[:n])
        v[n - 1] += (r[n] + top) << 16
        if not bool((_carry(v - 2 * p)[1] < 0).all()):
            raise ArithmeticError("a lane's lazy sum reduced to 2p or more")
        return B._reduced(r, p)

    def mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        nb1 = self.B.neg(b[1])
        lanes = [torch.stack(v, -1) for v in ((a[0], a[1]), (b[0], b[0]),
                                              (a[1], a[0]), (nb1, b[1]))]
        return self._redc_of_sums(*lanes).movedim(-1, 0)

    def sqr(self, a):
        B = self.B
        x = torch.stack([B.add(a[0], a[1]), a[0]], -1)
        y = torch.stack([B.sub(a[0], a[1]), B.double(a[1])], -1)
        return B.mul(x, y).movedim(-1, 0)

    def mul_small_const(self, a, c):
        mp = self.B.mp
        k = torch.tensor([hm.int_to_limbs(hm.to_mont(mp, int(v)), self.B.n)
                          for v in c], dtype=torch.int64, device=a.device)
        return self.mul(a, k.reshape(k.shape + (1,) * (a.ndim - 2)))


# -- the scan entry: Horner's phase in one launch ------------------------------

def tree_width(n: int) -> int:
    """The width proj_sum_tree pads n points to: 1 for n = 1, else the
    power of two >= n, at least 2 (group.py:536-563)."""
    return 1 << max(1, (n - 1).bit_length()) if n > 1 else 1


def _check_scan(G, totals, c: int) -> None:
    if len(totals) != 3:
        raise ValueError(f"the scan takes X, Y, Z, got {len(totals)} arrays")
    if not isinstance(c, int) or c < 0:
        raise ValueError(f"c is a window width >= 0, not {c!r}")
    if not G.a_is_zero:
        raise NotImplementedError(
            "the scan's complete formulas need a = 0 (ROADMAP Queue 1 "
            "item 10)")
    shape, dev = totals[0].shape, totals[0].device
    el = G.F.el_shape
    if len(shape) != len(el) + 1 or tuple(shape[:-1]) != el or shape[-1] < 1:
        raise ValueError(f"totals are {el} + (W,), W >= 1; got {tuple(shape)}")
    for t in totals:
        if t.shape != shape or t.device != dev or t.dtype != torch.int32:
            raise ValueError("totals differ in shape, device or dtype")


def horner_scan(G, totals, c: int):
    """sum_w 2^(c*w) * totals_w of the (*el, W) projective window totals
    [X, Y, Z]: window w doubled c*w times, then the padded sum tree, as
    _horner_complete's scan (pippenger.py:419-433).  Returns [X, Y, Z],
    each (*el,).  One launch of csrc/horner.cu on a CUDA tensor, the plain
    version on a CPU tensor."""
    totals = list(totals)
    _check_scan(G, totals, c)
    dev = totals[0].device
    if dev.type == "cpu":
        return horner_scan_plain(G, totals, c)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    k, b3, b3_mont = kernel_branch(G, "K3 scan")
    el = G.F.el_shape
    W = totals[0].shape[-1]
    M = tree_width(W)
    totals = [t.contiguous() for t in totals]
    slots = [torch.empty(el + (M,), dtype=torch.int32, device=dev)
             for _ in range(3)]
    arrivals = torch.zeros(M, dtype=torch.int32, device=dev)
    outs = [torch.empty(el, dtype=torch.int32, device=dev) for _ in range(3)]

    def ptrs(ts):
        return (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ts])

    Fp = G.F.prime_field
    fn = _build.function("horner", "horner_scan", _SCAN_ARGS)
    _build.launch(fn, f"K3 scan (k = {k})", dev, ptrs(totals), ptrs(slots),
                  ptrs(outs), _build.ptr(arrivals), W, M, c, Fp.n32, k, b3,
                  b3_mont, Fp.p_c, Fp.one_c, Fp.inv32, totals[0].get_device(),
                  _build.stream_ptr(totals[0]))
    _build.LAUNCHES[f"K3 scan g{k}"] += 1
    return outs


def horner_scan_plain(G, totals, c: int):
    """The plain version of the scan on any device: c*(W-1) masked
    doubling steps of every window (window w takes part while the step is
    below c*w), then the sum tree padded with the identity, over
    group_op_plain."""
    totals = list(totals)
    _check_scan(G, totals, c)
    F = G.F
    P = totals
    W = P[0].shape[-1]
    dev = P[0].device
    el = (None,) * F.el_ndim
    thresh = c * torch.arange(W, device=dev)
    for k in range(c * (W - 1)):
        live = (k < thresh)[el]
        P = [torch.where(live, d, a)
             for d, a in zip(group_op_plain(G, "pdbl", P), P)]
    M = tree_width(W)
    if M != W:
        one = F.one((M - W,), dev)
        zero = torch.zeros_like(one)
        P = [torch.cat([a, z], dim=-1) for a, z in zip(P, (zero, one, zero))]
    while P[0].shape[-1] > 1:
        h = P[0].shape[-1] // 2
        P = group_op_plain(G, "padd", [a[..., :h] for a in P]
                           + [a[..., h:] for a in P])
    return [a[..., 0] for a in P]
