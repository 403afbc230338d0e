"""Kernel K5: the lane merge of the MSM buckets (port of
libff_tpu/msm/pallas_insert3.py:36 ``_lane_merge``, :204 ``_merge_kernel``
and :250 ``_merge_lanes_kernel_call``, both branches: G1 over Fp and G2
over Fq2).

:func:`merge_lanes` takes raw projective buckets with coordinates ``(*el,
W, B, L)``, ``el`` the field's element dims, and returns ``(*el, W, B,
1)``: each (window, bucket)'s lane total.  L is any power of two (the TPU
kernel's ``L % 128 == 0`` follows its (Ls, 128) tiles).  The order of the
additions is the TPU kernel's, so the totals equal its lane 0 bit for bit:
level h = L/2, L/4, ..., 1 replaces lane l < h by ``padd(P_l, P_(l+h))``.
The kernel's Ls-halving slices are the levels h >= 128, and its roll
butterfly at stride s gives lane i ``padd(P_i, P_(i+s))``, whose lanes
i < s are those that reach lane 0: the levels h = 64 .. 1.  That is also
the halving loop of ``pippenger._reduce_buckets``, so every ``merge``
setting of the MSM gives the same buckets.  ``kmul`` chooses the
Montgomery product (``MsmConfig.kmul``, pallas_insert3.py:251-256): "cios"
builds from ``csrc/merge.cu``, "sos" and "sos2" from ``csrc/merge_sos.cu``
and ``csrc/merge_sos2.cu``; over 12-limb Fp (BLS12-381 and BLS12-377, G1
and G2) from ``csrc/merge_n12.cu``, ``merge_sos_n12.cu`` and
``merge_sos2_n12.cu``, counted as "K5 g1 n12", "K5 g2 n12 sos" and so on.
A CUDA tensor launches the kernel; a CPU tensor runs
:func:`merge_lanes_plain` over the same product.

On the card (``csrc/merge.cuh``) one warp takes a row: each of its
elements (a thread on G1, a pair of threads on G2 over CIOS, and at 12
limbs over every product) walks the levels h >= 32 (16 on G2 pairs) over
its own lanes depth first, the waiting partials in shared memory, and a
butterfly of warp shuffles runs the last levels.  Partials past a
thread's near slots (four at 8 limbs; at 12 as many as its blocks an SM
fit in shared memory: two on G1, four on G2) wait in a scratch array
(:func:`far_scratch`), which the library sizes (at 8 limbs only rows of
more than 32 lanes a thread need it: L > 1024 on G1, 512 on G2 pairs).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..curves import formulas as fml
from ..curves.group import ProjectivePoint
from ..curves.group_ops import kernel_branch
from ..fields.fp import KMULS, check_kmul, to16, to32

_ARGS = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_void_p)] * 2 + [
    _build.VP, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, _build.U32P, _build.U32P, _build.U32P, ctypes.c_uint32,
    ctypes.c_int, _build.VP]
_ARGS_FAR = [ctypes.c_int] * 3


def _check(G, buckets: ProjectivePoint, kmul: str):
    check_kmul(kmul)
    el = G.F.el_shape
    shape = buckets.z.shape
    if len(shape) != len(el) + 3 or tuple(shape[:len(el)]) != el:
        raise ValueError(f"bucket coordinates are {el} + (W, B, L); got "
                         f"{tuple(shape)}")
    for c in buckets:
        if (c.shape != shape or c.dtype != torch.int32
                or c.device != buckets.z.device):
            raise ValueError("bucket coordinates differ in shape, device or "
                             "dtype, or are not int32")
    L = shape[-1]
    if L < 1 or L & (L - 1):
        raise ValueError(f"the lane count must be a power of two, not {L}")
    if not G.a_is_zero:
        raise NotImplementedError("the lane merge's complete adds need a == 0")


def merge_lanes(G, buckets: ProjectivePoint,
                kmul: str = "cios") -> ProjectivePoint:
    """The lane total of each (window, bucket): (*el, W, B, L) ->
    (*el, W, B, 1).  kmul: the Montgomery product (KMULS)."""
    _check(G, buckets, kmul)
    dev = buckets.z.device
    if dev.type == "cpu":
        return merge_lanes_plain(G, buckets, kmul)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    k, b3, b3_mont = kernel_branch(G, "K5")
    W, B, L = buckets.z.shape[-3:]
    ins = [c.contiguous() for c in buckets]
    outs = [torch.empty(G.F.el_shape + (W, B, 1), dtype=torch.int32,
                        device=dev) for _ in range(3)]

    def ptrs(ts):
        return (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ts])

    Fp = G.F.prime_field
    stem = _build.width_stem(_build.kmul_stem("merge", kmul), Fp.n32)
    fn = _build.function(stem, "merge_lanes", _ARGS)
    far = far_scratch(stem, kmul, k, W * B, L, dev)
    name = _build.kmul_name(_build.width_name(f"K5 g{k}", Fp.n32), kmul)
    _build.launch(fn, f"{name} merge_lanes", dev, KMULS.index(kmul),
                  ptrs(ins), ptrs(outs),
                  None if far is None else _build.ptr(far), W * B, L,
                  Fp.n32, k, b3, b3_mont, Fp.p_c, Fp.one_c, Fp.inv32,
                  ins[0].get_device(), _build.stream_ptr(ins[0]))
    _build.LAUNCHES[name] += 1
    return ProjectivePoint(*outs)


def far_scratch(stem: str, kmul: str, k: int, n: int, L: int, dev):
    """The lane tree's scratch for n rows of L lanes on branch k, as the
    library built from csrc/<stem>.cu sizes it (its merge_far_words): an
    int32 tensor from torch.empty, or None where the rows need none."""
    words = _build.function(stem, "merge_far_words", _ARGS_FAR)(
        KMULS.index(kmul), k, L)
    if words < 0:
        raise ValueError(f"{stem} takes no lane tree of {L} lanes on G{k} "
                         f"over {kmul}")
    if words == 0:
        return None
    return torch.empty(n * words, dtype=torch.int32, device=dev)


def merge_lanes_plain(G, buckets: ProjectivePoint,
                      kmul: str = "cios") -> ProjectivePoint:
    """The plain version of K5 on any device: the levels h = L/2 .. 1 of
    the module docstring, each one batched complete add (K3's ``padd``,
    formulas.rcb_add_a0) over every (window, bucket) row, on the plain
    field with `kmul`'s product."""
    _check(G, buckets, kmul)
    F = G.F.plain.with_kmul(kmul)
    ax = G.F.el_ndim - 1                                # the limb axis
    W, B, L = buckets.z.shape[-3:]
    P = [to16(c, ax) for c in buckets]
    while L > 1:
        h = L // 2
        P = fml.rcb_add_a0(F, *(c[..., :h] for c in P),
                           *(c[..., h:] for c in P), G._b3_host)
        L = h
    return ProjectivePoint(*(to32(c, ax) for c in P))
