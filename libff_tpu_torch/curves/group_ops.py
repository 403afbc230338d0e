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
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..fields.fp import to16, to32
from . import formulas as fml

# op -> (its code in csrc/group_ops.cu, coordinate inputs, masks)
OPS = {"padd": (0, 6, 0), "pmadd": (1, 5, 1), "pdbl": (2, 3, 0),
       "add": (3, 6, 0), "madd": (4, 5, 1), "dbl": (5, 3, 0)}
_ARGS = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), _build.VP,
         ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, _build.U32P, _build.U32P, _build.U32P,
         ctypes.c_uint32, ctypes.c_int, _build.VP]


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
    coords, masks = list(coords), list(masks)
    _check(G, op, coords, masks)
    F = G.F.plain
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
