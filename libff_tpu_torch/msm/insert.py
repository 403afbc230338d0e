"""Kernels K2 and K6: the MSM bucket insert (port of
libff_tpu/msm/pallas_insert3.py, both branches: G1 over Fp and G2 over
Fq2, with its fused lane merge; and of libff_tpu/msm/pallas_insert.py, the
v1 insert, G1 only).

:func:`insert` keeps ``insert_pallas3``'s contract (pallas_insert3.py:301):
signed digits ``d (W, T, L)``; points ``(px, py, pneg, pinf)`` with
coordinates ``(*el, T, L)`` (``el`` the field's element dims) and ``pinf
(T, L)`` bool; it returns the raw projective buckets with coordinates
``(*el, W, B, L)``, bit-identical to the TPU kernel's after the limb
repack, or with ``merge=True`` their lane totals ``(*el, W, B, 1)``, in
``merge.py``'s order.  :func:`insert_v1` is ``insert_pallas``'s
counterpart (pallas_insert.py:198): the same function as :func:`insert`
on G1, refused on G2 as there.  ``kmul`` chooses the Montgomery product
inside K2 (``MsmConfig.kmul``, pallas_insert3.py:302): "cios" builds from
``csrc/insert.cu``, "sos" and "sos2" from ``csrc/insert_sos.cu`` and
``csrc/insert_sos2.cu``; every product gives the same buckets.  A CUDA
tensor launches the kernel; a CPU tensor runs :func:`insert_plain` (and
``merge_lanes_plain``) over the same product.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..curves import formulas as fml
from ..curves.group import ProjectivePoint
from ..curves.group_ops import kernel_branch
from ..fields.fp import KMULS, check_kmul, to16, to32
from .merge import merge_lanes_plain

_ARGS = [ctypes.c_int] + [_build.VP] * 8 + [ctypes.c_int] * 7 + [
    _build.U32P, _build.U32P, _build.U32P, ctypes.c_uint32, _build.VP,
    ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, _build.VP]
_ARGS_V1 = [_build.VP] * 8 + [ctypes.c_int] * 6 + [
    _build.U32P, _build.U32P, ctypes.c_uint32, ctypes.c_int, _build.VP]
# L % 128 == 0 puts every block of the fused merge in one window, as
# insert_pallas3 requires it of every L (pallas_insert3.py:333)
MERGE_LANE_MULTIPLE = 128


def _check(G, d, pts, B, kmul="cios"):
    check_kmul(kmul)
    px, py, pneg, pinf = pts
    if d.ndim != 3 or d.dtype != torch.int32:
        raise ValueError("digits are (W, T, L) int32")
    W, T, L = d.shape
    el = G.F.el_shape
    for c in (px, py, pneg):
        if c.shape != el + (T, L) or c.dtype != torch.int32:
            raise ValueError(f"point coordinates are {el + (T, L)} int32")
    if pinf.shape != (T, L) or pinf.dtype != torch.bool:
        raise ValueError(f"pinf is ({T}, {L}) bool")
    if any(a.device != d.device for a in pts):
        raise ValueError("digits and points lie on different devices")
    if B < 1:
        raise ValueError("B >= 1 buckets")
    if not G.a_is_zero:
        raise NotImplementedError("the complete insert needs a == 0")


def insert(G, d: torch.Tensor, pts, B: int, merge: bool = False,
           kmul: str = "cios") -> ProjectivePoint:
    """Bucket accumulation: bucket |d|-1 of (window, lane) += +-P in t
    order; zero digits and points at infinity leave it unchanged.  With
    merge, the lane axis is then tree-summed in the same launch (K2's
    fused branch, pallas_insert3.py:172-201) and (*el, W, B, 1) returned;
    it needs L % 128 == 0.  kmul: the Montgomery product (KMULS)."""
    _check(G, d, pts, B, kmul)
    W, T, L = d.shape
    if merge and L % MERGE_LANE_MULTIPLE:
        raise ValueError(f"the fused merge needs L % {MERGE_LANE_MULTIPLE} "
                         f"== 0, not L = {L}")
    if d.device.type == "cpu":
        raw = insert_plain(G, d, pts, B, kmul)
        return merge_lanes_plain(G, raw, kmul) if merge else raw
    if d.device.type != "cuda":
        raise ValueError(f"no kernel for device {d.device}")
    k, b3, b3_mont = kernel_branch(G, "K2")
    ts = _kernel_tensors(G, d, pts, B)
    out, counter, m = ts[5:], None, None
    if merge:
        out = [torch.empty(G.F.el_shape + (W, B, 1), dtype=torch.int32,
                           device=d.device) for _ in range(3)]
        # the arrivals per window of the last-block merge
        counter = torch.zeros(W, dtype=torch.int32, device=d.device)
        m = (ctypes.c_void_p * 3)(*[o.data_ptr() for o in out])
    Fp = G.F.prime_field
    fn = _build.function(_build.kmul_stem("insert", kmul), "insert", _ARGS)
    name = _build.kmul_name(f"{'K2m' if merge else 'K2'} g{k}", kmul)
    _build.launch(fn, f"{name} insert", d.device, KMULS.index(kmul),
                  *(_build.ptr(t) for t in ts), W, T, L, B, Fp.n32, k, b3,
                  b3_mont, Fp.p_c, Fp.one_c, Fp.inv32,
                  None if counter is None else _build.ptr(counter), m,
                  d.get_device(), _build.stream_ptr(d))
    _build.LAUNCHES[name] += 1
    return ProjectivePoint(*out)


def insert_v1(G, d: torch.Tensor, pts, B: int) -> ProjectivePoint:
    """Kernel K6, the v1 insert (insert_pallas): G1 only, raw buckets
    (n, W, B, L).  The same function as :func:`insert`'s G1 branch, whose
    kernel it launches under its own entry point and launch count; the
    v1/v3 difference on the TPU is a VMEM tile shape."""
    _check(G, d, pts, B)
    if G.F.el_ndim != 1:
        raise ValueError("the v1 insert supports prime-field G1 only "
                         "(pallas_insert.py:212)")
    if d.device.type == "cpu":
        return insert_plain(G, d, pts, B)
    if d.device.type != "cuda":
        raise ValueError(f"no kernel for device {d.device}")
    kernel_branch(G, "K6")
    W, T, L = d.shape
    ts = _kernel_tensors(G, d, pts, B)
    Fp = G.F.prime_field
    fn = _build.function("insert", "insert_v1", _ARGS_V1)
    _build.launch(fn, "K6 insert_v1", d.device, *(_build.ptr(t) for t in ts),
                  W, T, L, B, Fp.n32, G._b3_host, Fp.p_c, Fp.one_c, Fp.inv32,
                  d.get_device(), _build.stream_ptr(d))
    _build.LAUNCHES["K6 g1"] += 1
    return ProjectivePoint(*ts[5:])


def _kernel_tensors(G, d, pts, B) -> list[torch.Tensor]:
    """What both entry points read and write, in their order: the
    digits, the point coordinates and flags, and the three raw bucket
    arrays.  The caller holds the list until the launch is queued."""
    W, _, L = d.shape
    px, py, pneg, pinf = (a.contiguous() for a in pts)
    raw = [torch.empty(G.F.el_shape + (W, B, L), dtype=torch.int32,
                       device=d.device) for _ in range(3)]
    return [d.contiguous(), px, py, pneg, pinf.to(torch.int32).contiguous(),
            *raw]


def insert_plain(G, d: torch.Tensor, pts, B: int,
                 kmul: str = "cios") -> ProjectivePoint:
    """The plain version of K2 on any device: a loop over t with
    gather/scatter on the bucket axis and formulas.rcb_madd_a0 over the
    plain field with `kmul`'s product (pallas_insert3.py:127-170)."""
    _check(G, d, pts, B, kmul)
    F = G.F.plain.with_kmul(kmul)
    ax = G.F.el_ndim - 1                                # the limb axis
    px, py, pneg, pinf = pts
    W, T, L = d.shape
    dev = d.device
    one = to16(G.F.one((W, B, L), dev), ax)
    bx, by, bz = torch.zeros_like(one), one.clone(), torch.zeros_like(one)
    el16 = tuple(one.shape[:ax + 1])
    lead = (None,) * len(el16)
    px, py, pneg = (to16(a, ax) for a in (px, py, pneg))
    for t in range(T):
        dt = d[:, t, :].to(torch.int64)                  # (W, L)
        absd = dt.abs()
        idx = (absd - 1).clamp(0, B - 1)
        valid = ((absd > 0) & ~pinf[t][None, :])[lead]
        gi = idx[:, None, :].expand(el16 + (W, 1, L))
        cx, cy, cz = (b.gather(ax + 2, gi).squeeze(ax + 2)
                      for b in (bx, by, bz))
        qx = px[..., t, None, :].expand(el16 + (W, L))
        qy = torch.where((dt < 0)[lead], pneg[..., t, None, :],
                         py[..., t, None, :])
        new = fml.rcb_madd_a0(F, cx, cy, cz, qx, qy, G._b3_host)
        for b, cur, nv in zip((bx, by, bz), (cx, cy, cz), new):
            b.scatter_(ax + 2, gi,
                       torch.where(valid, nv, cur).unsqueeze(ax + 2))
    return ProjectivePoint(to32(bx, ax), to32(by, ax), to32(bz, ax))
