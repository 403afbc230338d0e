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

Both entries are built for alt_bn128's 8-limb G1 and G2 and for the G1
and G2 of BLS12-381 and BLS12-377 over 12-limb Fp (:func:`kernel_branch`),
each width from its own sources (``csrc/group_ops_n12.cu``,
``csrc/horner_n12.cu``), and K3's 12-limb G2 from one source for each
non-residue (:func:`k3_stem`).

:func:`horner_scan` is K3's scan entry: the Horner phase of the MSM
(libff_tpu/msm/pippenger.py:419-433, a scan of masked pdbl steps and a sum
tree) as one launch of ``csrc/horner.cu`` on a CUDA tensor, and
:func:`horner_scan_plain`, the same steps over :func:`group_op_plain`, on
a CPU tensor.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..fields.fp import KERNEL_WIDTHS, _carry, to16, to32
from ..fields.tower import PlainField2, kernel_nr
from ..host import mont as hm
from . import formulas as fml

# the G1 branches' b3 by width: the constants the kernels' addition
# chains are instantiated for (formulas.cuh FpField<N, B3>)
G1_B3 = {8: (9,), 12: (12, 3)}
# op -> (its code in csrc/group_ops.cu, coordinate inputs, masks)
OPS = {"padd": (0, 6, 0), "pmadd": (1, 5, 1), "pdbl": (2, 3, 0),
       "add": (3, 6, 0), "madd": (4, 5, 1), "dbl": (5, 3, 0)}
# the ops with a split body at 12 limbs (csrc/split_ops.cuh: the G1 pair,
# the G2 quad)
PAIR_OPS = ("padd", "pmadd")
_ARGS = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_longlong, _build.VP,
         ctypes.POINTER(ctypes.c_void_p),
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         _build.U32P, _build.U32P, _build.U32P, ctypes.c_uint32, ctypes.c_int,
         _build.VP]
_PTRS3 = ctypes.POINTER(ctypes.c_void_p)
_SCAN_ARGS = [_PTRS3, _PTRS3, _PTRS3, _build.VP, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              _build.U32P, _build.U32P, _build.U32P, ctypes.c_uint32,
              ctypes.c_int, _build.VP]


def kernel_branch(G, what: str):
    """The CUDA kernels' branch for group G as (k, b3, b3's Montgomery
    limbs): k = 1 for a G1 whose b3 is a small constant of the kernels
    (an addition chain): alt_bn128's (8 limbs, b3 = 9), BLS12-381's (12
    limbs, b3 = 12) and BLS12-377's (12 limbs, b3 = 3), with no limbs;
    k = 2 for a G2 over an Fq2 whose non-residue the kernels are built for
    (``tower.FQ2_NRS``, the G2 branches' counterpart of ``G1_B3``:
    alt_bn128's nr = p - 1 at 8 limbs, BLS12-381's p - 1 and BLS12-377's
    p - 5 at 12), with nr - p in place of b3 and the limbs of
    b3 = (c0, c1), a runtime constant.  The library is the width's
    (``_build.width_stem``).  Raises for any other group: other widths
    wait for ROADMAP Queue 1 item 9d."""
    F = G.F
    n32 = F.prime_field.n32
    if n32 not in KERNEL_WIDTHS:
        raise NotImplementedError(
            f"{what} is built for 8 and 12 limbs, not {n32} ({G.name}): "
            "wider fields wait for ROADMAP Queue 1 item 9d")
    if F.el_ndim == 1 and G._b3_host in G1_B3[n32]:
        return 1, G._b3_host, None
    nr = kernel_nr(F) if F.el_ndim == 2 else None
    if nr is not None:
        return 2, nr, _build.u32_array(F.mont_limbs(G._b3_host))
    raise NotImplementedError(
        f"{what} is built for alt_bn128 G1 (b3 = 9) and G2 (Fq2 with nr = "
        f"p - 1), BLS12-381 and BLS12-377 G1 (b3 = 12, 3) and their G2 "
        f"(nr = p - 1, p - 5), not {G.name}")


def k3_stem(n32: int, k: int, b3: int) -> str:
    """The library of K3 for :func:`kernel_branch`'s (k, b3) at n32
    limbs: the width's (``csrc/group_ops.cu``, ``group_ops_n12.cu``), and
    at 12 limbs the G2 branch's own for each non-residue
    (``group_ops_g2_n12.cu`` for nr = -1, ``group_ops_g2_nr5_n12.cu`` for
    -5), which nvcc builds in parallel."""
    if k == 1 or n32 == 8:
        return _build.width_stem("group_ops", n32)
    return _build.width_stem(
        "group_ops_g2" + ("" if b3 == -1 else f"_nr{-b3}"), n32)


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
    if len(shape) <= len(el) or tuple(shape[:len(el)]) != el:
        raise ValueError(f"coordinates are {el} + batch; got {tuple(shape)}")
    for c in coords:
        if c.shape != shape or c.device != dev or c.dtype != torch.int32:
            raise ValueError("coordinates differ in shape, device or dtype")
    for m in masks:
        if (m.shape != shape[len(el):] or m.device != dev
                or m.dtype != torch.bool):
            raise ValueError("masks are batch-shaped bool on the "
                             "coordinates' device")


def input_layout(c: torch.Tensor, el_ndim: int, n32: int):
    """(limb stride, row stride, cols) in words of the coordinate view c,
    (*el, *batch), as K3 reads it: element e of the batch in row-major
    order is row e // cols, column e % cols (cols the last batch dim
    longer than 1), at row * row stride + column from c's first word, its
    limbs limb stride apart (an Fq2 coefficient n32 limbs on); batch
    rows that follow each other make one row of all n elements.  None
    where c's strides do not have that form (a column broadcast, a
    permuted dim): the kernel then reads a contiguous copy."""
    st = c.stride()
    el_st = st[:el_ndim]
    batch = [(s, d) for s, d in zip(st[el_ndim:], c.shape[el_ndim:]) if d > 1]
    if el_ndim == 2 and el_st[0] != n32 * el_st[1]:
        return None
    if not batch:
        return el_st[-1], 1, 1
    if batch[-1][0] != 1:
        return None
    # the leading batch dims collapse into rows of one stride
    for (s, _), (s2, d2) in zip(batch[:-2], batch[1:-1]):
        if s != s2 * d2:
            return None
    cols = batch[-1][1]
    rows = batch[-2][0] if len(batch) > 1 else cols
    if rows == cols:
        n = math.prod(d for _, d in batch)
        return el_st[-1], n, n
    return el_st[-1], rows, cols


def group_op(G, op: str, coords, masks=()):
    """One batched group op over (*el, *batch) coordinates; returns [X, Y,
    Z], each (*el, *batch).  padd reads its inputs where they lie when
    they share one ``input_layout`` (the lane halving's halves); the
    other ops read flat inputs, copies where they are not."""
    coords, masks = list(coords), list(masks)
    _check(G, op, coords, masks)
    dev = coords[0].device
    if dev.type == "cpu":
        return group_op_plain(G, op, coords, masks)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    k, b3, b3_mont = kernel_branch(G, "K3")
    Fp = G.F.prime_field
    nd = G.F.el_ndim
    # padd reads views in rows of one layout; otherwise the inputs are
    # copied, unless flat (contiguous inputs, the usual case, skip the
    # layouts: a few microseconds of host time a launch)
    n = coords[0].shape[nd:].numel()
    layouts = {(n, n, n)}
    if not all(c.is_contiguous() for c in coords):
        layouts = {input_layout(c, nd, Fp.n32) for c in coords}
    if len(layouts) != 1 or None in layouts or (
            op != "padd" and layouts != {(n, n, n)}):
        coords = [c.contiguous() for c in coords]
        layouts = {input_layout(coords[0], nd, Fp.n32)}
    (lstride, rstride, cols), = layouts
    mask = (masks[0].reshape(-1).to(torch.int32) if masks else None)
    shape = coords[0].shape
    outs = [torch.empty(shape, dtype=torch.int32, device=dev)
            for _ in range(3)]
    ins = (ctypes.c_void_p * 6)(*([c.data_ptr() for c in coords]
                                  + [None] * (6 - len(coords))))
    ous = (ctypes.c_void_p * 3)(*[o.data_ptr() for o in outs])
    name = _build.width_name(f"K3 g{k}", Fp.n32)
    fn = _build.function(k3_stem(Fp.n32, k, b3), "group_op_at", _ARGS)
    _build.launch(fn, f"{name} group_op {op}", dev, OPS[op][0], ins,
                  lstride, rstride, cols, _build.ptr(mask) if mask is not None
                  else None, ous, n, Fp.n32, k, b3, b3_mont, Fp.p_c,
                  Fp.one_c, Fp.inv32, coords[0].get_device(),
                  _build.stream_ptr(coords[0]))
    _build.LAUNCHES[name] += 1
    return outs


def kernel_reads(c: torch.Tensor, el_ndim: int, n32: int) -> torch.Tensor:
    """The (*el, n) words that K3 reads for the coordinate view c, on any
    device: its addresses from ``input_layout`` gathered from c's storage,
    as the kernel computes them (the CPU tests' emulation of the in-place
    reads)."""
    ls, rs, cols = input_layout(c, el_ndim, n32)
    el = c.shape[:el_ndim]
    e = torch.arange(c.shape[el_ndim:].numel())
    at = (e // cols) * rs + e % cols
    limb = torch.arange(math.prod(el)).reshape(el)     # c n32 + i on Fq2
    idx = c.storage_offset() + limb[..., None] * ls + at
    words = torch.as_strided(c, (c.untyped_storage().nbytes() // 4,), (1,), 0)
    return words[idx.to(c.device)]


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
    if F.el_ndim != 2 or kernel_nr(F) is None:
        raise NotImplementedError(
            "the pair schedule is built for the G2 branches' Fq2 (nr = p - 1 "
            "or p - 5, tower.FQ2_NRS)")
    return _group_op_over(G, PairField2(F.plain.B, F.nr), op, coords, masks)


def group_op_split_plain(G, op: str, coords, masks=()):
    """K3's split body (csrc/split_ops.cuh: padd and pmadd at 12 limbs,
    each level's products split between two halves of an element's
    threads) as the kernel schedules it, on any device: the G1 pair (a
    value a thread, over the plain field) or the G2 quad (a value a pair,
    over :class:`PairField2`, each Fq2 product as the pair's lazy sums).
    Each value is a tensor with a trailing axis of the two halves, each
    step the kernel's, selects by half as `pick`, swaps between the halves
    as flips of that axis; the outputs are the values both halves end
    with, each checked to agree.  Gives group_op_plain's bits."""
    coords, masks = list(coords), list(masks)
    _check(G, op, coords, masks)
    nd = G.F.el_ndim
    if op not in PAIR_OPS or (nd == 2 and kernel_nr(G.F) is None):
        raise NotImplementedError(
            f"the split body runs {PAIR_OPS} over Fp and over the G2 "
            f"branches' Fq2, not {op} on {G.name}")
    F = G.F.plain if nd == 1 else PairField2(G.F.plain.B, G.F.nr)
    b3, ax = G._b3_host, nd - 1
    c1 = torch.tensor([False, True], device=coords[0].device)
    cs = [to16(c, ax) for c in coords]

    def ld(i0, i1=None):
        return torch.stack([cs[i0], cs[i0 if i1 is None else i1]], -1)

    def pick(x, y):
        return torch.where(c1, y, x)

    def swap(x):
        return x.flip(-1)

    mul, add, sub, dbl = F.mul, F.add, F.sub, F.double

    def mul_b3(x):
        return F.mul_small_const(x, b3)

    def level2(p, q, r, s):
        pq, qr, sp = mul(p, q), mul(q, r), mul(s, p)
        pqo, qro, spo = swap(pq), swap(qr), swap(sp)
        return [sub(pick(pq, pqo), pick(pqo, pq)), add(qr, qro), add(sp, spo)]

    if op == "padd":
        a1, a2, y1, y2 = ld(0, 2), ld(3, 5), ld(1), ld(4)
        m1 = mul(a1, a2)
        m2 = mul(pick(y1, add(y1, a1)), pick(y2, add(y2, a2)))
        x1, x2 = ld(0), ld(3)
        m3 = mul(add(x1, pick(y1, a1)), add(x2, pick(y2, a2)))
        o1, o2 = swap(m1), swap(m2)
        T0, T2, T1 = pick(m1, o1), pick(o1, m1), pick(m2, o2)
        w = sub(m3, add(T0, pick(T1, T2)))
        bb = mul_b3(pick(T2, w))
        zs = add(T1, pick(bb, T2))
        q0 = sub(pick(T1, m2), pick(bb, zs))
        tn = add(dbl(T0), T0)
        zo = swap(zs)
        out = level2(pick(w, q0), pick(q0, bb), pick(zs, tn), pick(tn, zo))
    else:
        z1, qx, qy, x1, y1 = ld(2), ld(3), ld(4), ld(0), ld(1)
        m1 = mul(pick(x1, z1), qx)
        m2 = mul(pick(y1, z1), qy)
        m3 = mul(add(qx, qy), add(x1, y1))
        u = add(m1, x1)
        bz = mul_b3(pick(z1, u))
        zs = add(m2, pick(bz, y1))
        q0 = sub(m2, bz)
        w = sub(m3, add(m1, m2))
        tn = add(dbl(m1), m1)
        tno, zso = swap(tn), swap(zs)
        out = level2(pick(w, zs), pick(q0, bz), pick(zs, tno), pick(tn, zso))
        q_inf = masks[0][(None,) * nd + (..., None)]
        out = [torch.where(q_inf, p, r) for p, r in zip((x1, y1, z1), out)]
    for v in out:
        if not torch.equal(v[..., 0], v[..., 1]):
            raise ArithmeticError("the halves end with other values")
    return [to32(v[..., 0], ax) for v in out]


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
    """Fq2 (nr = p - 1 or p - 5) on (2, n16, *batch) int64 tensors as the
    two threads of csrc/fp2_pair.cuh compute it: coefficient c of a
    product is lane c's REDC(x0 y0 + x1 y1), with (x0, y0, x1, y1) = (a0,
    b0, a1, nr b1) on lane 0 and (a1, b0, a0, b1) on lane 1, nr b1
    canonical, each row of the reduction adding both products' row before
    its quotient (CIOS, in 16-bit rows where the kernel takes 32-bit ones:
    the same residue); a square is one product a lane, (a0 + a1)(a0 - a1)
    and a0 (2 a1) with nr = p - 1, with another nr (a0 + a1)(a0 + nr a1) =
    t and a1 a0 = v, swapped into t - v - nr v and 2v; the product by b3 is
    the product by its Montgomery constant.  Both lanes
    run as one stacked batch.  Additions are PlainField2's."""

    def __init__(self, B, nr: int | None = None):
        super().__init__(B, B.p - 1 if nr is None else nr)
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
        nb1 = self.mul_by_nr(b[1])
        lanes = [torch.stack(v, -1) for v in ((a[0], a[1]), (b[0], b[0]),
                                              (a[1], a[0]), (nb1, b[1]))]
        return self._redc_of_sums(*lanes).movedim(-1, 0)

    def sqr(self, a):
        B = self.B
        if self.nr != B.p - 1:
            # lane 0 t = (a0 + a1)(a0 + nr a1), lane 1 v = a1 a0; swapped,
            # c0 = t - v - nr v, c1 = 2v
            x = torch.stack([B.add(a[0], a[1]), a[1]], -1)
            y = torch.stack([B.add(a[0], self.mul_by_nr(a[1])), a[0]], -1)
            t, v = B.mul(x, y).unbind(-1)
            return torch.stack([B.sub(t, B.add(v, self.mul_by_nr(v))),
                                B.double(v)])
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
    name = _build.width_name(f"K3 scan g{k}", Fp.n32)
    fn = _build.function(_build.width_stem("horner", Fp.n32), "horner_scan",
                         _SCAN_ARGS)
    _build.launch(fn, name, dev, ptrs(totals), ptrs(slots),
                  ptrs(outs), _build.ptr(arrivals), W, M, c, Fp.n32, k, b3,
                  b3_mont, Fp.p_c, Fp.one_c, Fp.inv32, totals[0].get_device(),
                  _build.stream_ptr(totals[0]))
    _build.LAUNCHES[name] += 1
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
