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
``csrc/insert_sos2.cu``; every product gives the same buckets.  Over
12-limb Fp (BLS12-381 and BLS12-377, G1 and their G2 over Fq2) K2, K2m
and K6 build from ``csrc/insert_n12.cu`` and K2 and K2m over the SOS
products from ``csrc/insert_sos_n12.cu`` and ``csrc/insert_sos2_n12.cu``,
every setting of the 8-limb path, counted with the width before the
product: "K2 g1 n12", "K2m g2 n12 sos", "K6 g1 n12" and so on.

On the card K2 is the sort :func:`bucket_lists`, which lists each
(window, lane)'s steps by bucket in t order, then the chain kernel, which
walks each bucket's list in registers over the points repacked by
:func:`point_records`, and for the raw buckets a repack into the
contract's layout (``csrc/insert.cuh``).  With merge=True (K2m) the
repack gives way to K5's lane tree (``csrc/merge.cuh``), launched by the
same C call on the chain kernel's lane-major buckets.  A CUDA tensor
launches the kernels; a CPU tensor runs the plain versions,
:func:`insert_plain` (and ``merge_lanes_plain``) over the same product and
:func:`bucket_lists_plain`.  For the tests, :func:`bucket_lists_by_groups`
lists the steps as the sort kernel does and
:func:`insert_from_lists_plain` walks the lists as the chain kernel does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..curves import formulas as fml
from ..curves.group import ProjectivePoint
from ..curves.group_ops import PairField2, kernel_branch
from ..fields.fp import KMULS, check_kmul, to16, to32
from ..fields.tower import kernel_nr
from .merge import far_scratch, merge_lanes_plain

_PTRS = ctypes.POINTER(ctypes.c_void_p)
_ARGS = [ctypes.c_int, _build.VP, _build.VP, ctypes.c_int, _build.VP,
         _PTRS] + [_build.VP] * 3 + [ctypes.c_int] * 7 + [
    _build.U32P, _build.U32P, _build.U32P, ctypes.c_uint32, _PTRS,
    _build.VP, ctypes.c_int, _build.VP]
_ARGS_V1 = [_build.VP, _build.VP, ctypes.c_int, _build.VP, _PTRS] + [
    _build.VP] * 3 + [ctypes.c_int] * 6 + [
    _build.U32P, _build.U32P, ctypes.c_uint32, ctypes.c_int, _build.VP]
_ARGS_SORT = [_build.VP] * 4 + [ctypes.c_int] * 6 + [_build.VP]
# the fused merge's lanes: insert_pallas3 requires L % 128 == 0
# (pallas_insert3.py:333), and so does the port, for the same contract
MERGE_LANE_MULTIPLE = 128
# a list entry is 2t + (digit < 0): int16 holds it while T <= 16384
INT16_ENTRIES_MAX_T = 1 << 14
# the buckets a pass of the sort kernel counts (insert.cuh kSortBins)
SORT_BINS = 256


def _check(G, d, pts, B, kmul="cios"):
    check_kmul(kmul)
    px, py, pneg, pinf = pts
    _check_lists_inputs(d, pinf, B)
    _, T, L = d.shape
    el = G.F.el_shape
    for c in (px, py, pneg):
        if c.shape != el + (T, L) or c.dtype != torch.int32:
            raise ValueError(f"point coordinates are {el + (T, L)} int32")
    if any(a.device != d.device for a in pts):
        raise ValueError("digits and points lie on different devices")
    if not G.a_is_zero:
        raise NotImplementedError("the complete insert needs a == 0")


def _check_lists_inputs(d, pinf, B):
    if d.ndim != 3 or d.dtype != torch.int32:
        raise ValueError("digits are (W, T, L) int32")
    _, T, L = d.shape
    if pinf.shape != (T, L) or pinf.dtype != torch.bool:
        raise ValueError(f"pinf is ({T}, {L}) bool")
    if pinf.device != d.device:
        raise ValueError("digits and pinf lie on different devices")
    if B < 1:
        raise ValueError("B >= 1 buckets")


def entry_dtype(T: int) -> torch.dtype:
    """The dtype of the list entries for T steps."""
    return torch.int16 if T <= INT16_ENTRIES_MAX_T else torch.int32


def bucket_lists(G, d: torch.Tensor, pinf: torch.Tensor, B: int):
    """K2's sort: for each (window, lane), the steps t whose digit is not
    zero and whose point is finite, grouped by bucket min(|d| - 1, B - 1)
    and in t order within a bucket.  Returns (off, ent): off (W, L, B + 1)
    int32, the start of each bucket's list and the end of the last; ent
    (W, L, T) of :func:`entry_dtype`, each entry 2t + (d < 0), then -1 to
    the end of the row.  Counted as "K2 sort g1" or "K2 sort g2" by G's
    branch."""
    _check_lists_inputs(d, pinf, B)
    if d.device.type == "cpu":
        return bucket_lists_plain(d, pinf, B)
    if d.device.type != "cuda":
        raise ValueError(f"no kernel for device {d.device}")
    k, _, _ = kernel_branch(G, "K2")
    return _bucket_lists(d, pinf, B, k)


def _bucket_lists(d, pinf, B, k):
    W, T, L = d.shape
    off = torch.empty((W, L, B + 1), dtype=torch.int32, device=d.device)
    ent = torch.empty((W, L, T), dtype=entry_dtype(T), device=d.device)
    pinf, d = pinf.contiguous(), d.contiguous()   # the kernel reads bool bytes
    fn = _build.function("insert", "bucket_lists", _ARGS_SORT)
    _build.launch(fn, f"K2 sort g{k}", d.device, _build.ptr(d),
                  _build.ptr(pinf), _build.ptr(off), _build.ptr(ent),
                  int(ent.dtype == torch.int32), W, T, L, B, d.get_device(),
                  _build.stream_ptr(d))
    _build.LAUNCHES[f"K2 sort g{k}"] += 1
    return off, ent


def bucket_keys(d: torch.Tensor, pinf: torch.Tensor, B: int) -> torch.Tensor:
    """The sort's keys, (W, L, T): each step's bucket min(|d| - 1, B - 1),
    or B for a step that adds nothing (a zero digit, a point at
    infinity)."""
    dl = d.permute(0, 2, 1)                              # (W, L, T)
    return torch.where((dl != 0) & ~pinf.T[None],
                       (dl.abs() - 1).clamp(max=B - 1), B).contiguous()


def bucket_lists_plain(d: torch.Tensor, pinf: torch.Tensor, B: int):
    """The plain version of :func:`bucket_lists` on any device: a stable
    sort of each (window, lane)'s steps by bucket (:func:`bucket_keys`),
    the steps that add nothing last."""
    _check_lists_inputs(d, pinf, B)
    W, T, L = d.shape
    dl = d.permute(0, 2, 1)                              # (W, L, T)
    key = bucket_keys(d, pinf, B)
    skey, t = torch.sort(key, dim=-1, stable=True)
    neg = (dl < 0).gather(-1, t)
    ent = torch.where(skey < B, 2 * t + neg, -1).to(entry_dtype(T))
    starts = torch.arange(B + 1, dtype=skey.dtype, device=d.device)
    off = torch.searchsorted(skey, starts.expand(W, L, B + 1).contiguous())
    return off.to(torch.int32), ent


def bucket_lists_by_groups(d: torch.Tensor, pinf: torch.Tensor, B: int,
                           group: int = 32, bins: int = SORT_BINS):
    """:func:`bucket_lists` as the sort kernel computes it, in plain torch
    ops: per (window, lane), passes of `bins` buckets; a pass counts its
    buckets' keys, turns the counts into starts, then takes the steps
    `group` at a time (a warp's 32 in the kernel): each goes to its
    bucket's start plus the number of steps of the group before it with
    the same key, and each start moves past the group's steps.  The same
    (off, ent) as :func:`bucket_lists_plain`."""
    _check_lists_inputs(d, pinf, B)
    W, T, L = d.shape
    key = bucket_keys(d, pinf, B).long()                 # (W, L, T)
    neg = (d.permute(0, 2, 1) < 0).long()
    off = torch.empty((W, L, B + 1), dtype=torch.int32, device=d.device)
    ent = torch.full((W, L, T + 1), -1, dtype=torch.long, device=d.device)
    base = torch.zeros((W, L, 1), dtype=torch.long, device=d.device)
    earlier = torch.ones(group, group, dtype=torch.bool,
                         device=d.device).tril(-1)       # [j, i]: i < j
    for b0 in range(0, B, bins):
        nb = min(bins, B - b0)
        k = key - b0
        live = (k >= 0) & (k < nb)
        k = torch.where(live, k, nb)                     # nb: not this pass
        cnt = torch.zeros((W, L, nb + 1), dtype=torch.long, device=d.device)
        cnt = cnt.scatter_add_(-1, k, torch.ones_like(k))[..., :nb]
        start = base + cnt.cumsum(-1) - cnt
        off[..., b0:b0 + nb] = start.to(torch.int32)
        base = base + cnt.sum(-1, keepdim=True)
        start = torch.cat([start, torch.zeros_like(base)], -1)
        for t0 in range(0, T, group):
            kg, lg = k[..., t0:t0 + group], live[..., t0:t0 + group]
            n = kg.shape[-1]
            peers = (kg[..., :, None] == kg[..., None, :]) & earlier[:n, :n]
            pos = start.gather(-1, kg) + peers.sum(-1)
            t = torch.arange(t0, t0 + n, device=d.device)
            ent.scatter_(-1, torch.where(lg, pos, T),
                         2 * t + neg[..., t0:t0 + group])
            start.scatter_add_(-1, kg, torch.ones_like(kg))
    off[..., B] = base[..., 0].to(torch.int32)
    return off, ent[..., :T].to(entry_dtype(T))


def point_records(G, pts) -> torch.Tensor:
    """The points as K2's chain kernel reads them: (T * L, 3, K) int32,
    point t*L + l's x, y and -y each as its K words contiguous (K = 8 on
    G1, 16 on G2, c0's limbs then c1's)."""
    px, py, pneg, _ = pts
    T, L = px.shape[-2:]
    K = math.prod(G.F.el_shape)
    rec = torch.empty((T * L, 3, K), dtype=torch.int32, device=px.device)
    for i, a in enumerate((px, py, pneg)):
        rec[:, i] = a.reshape(K, T * L).T
    return rec


def insert(G, d: torch.Tensor, pts, B: int, merge: bool = False,
           kmul: str = "cios") -> ProjectivePoint:
    """Bucket accumulation: bucket |d|-1 of (window, lane) += +-P in t
    order; zero digits and points at infinity leave it unchanged.  With
    merge, the lane axis is then tree-summed in K5's order by the same C
    call (K2's fused branch, pallas_insert3.py:172-201; counted once, as
    "K2m") and (*el, W, B, 1) returned; it needs L % 128 == 0.  kmul: the
    Montgomery product (KMULS)."""
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
    off, ent, rec, lane, out = _kernel_tensors(
        G, d, pts, B, k, (W, B, 1) if merge else (W, B, L))
    raw = [None] * 3 if merge else out
    Fp = G.F.prime_field
    stem = _build.width_stem(_build.kmul_stem("insert", kmul), Fp.n32)
    fn = _build.function(stem, "insert", _ARGS)
    far = far_scratch(stem, kmul, k, W * B, L, d.device) if merge else None
    name = _build.kmul_name(
        _build.width_name(f"{'K2m' if merge else 'K2'} g{k}", Fp.n32), kmul)
    _build.launch(fn, f"{name} insert", d.device, KMULS.index(kmul),
                  _build.ptr(off), _build.ptr(ent),
                  int(ent.dtype == torch.int32), _build.ptr(rec),
                  _ptr_array(lane),
                  *(None if t is None else _build.ptr(t) for t in raw),
                  W, T, L, B, Fp.n32, k, b3, b3_mont, Fp.p_c, Fp.one_c,
                  Fp.inv32, _ptr_array(out) if merge else None,
                  None if far is None else _build.ptr(far), d.get_device(),
                  _build.stream_ptr(d))
    _build.LAUNCHES[name] += 1
    return ProjectivePoint(*out)


def insert_v1(G, d: torch.Tensor, pts, B: int) -> ProjectivePoint:
    """Kernel K6, the v1 insert (insert_pallas): G1 only, raw buckets
    (n, W, B, L).  The same function as :func:`insert`'s G1 branch, whose
    sort and chain kernel it launches under its own entry point and launch
    count; the v1/v3 difference on the TPU is a VMEM tile shape."""
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
    off, ent, rec, lane, raw = _kernel_tensors(G, d, pts, B, 1, (W, B, L))
    Fp = G.F.prime_field
    fn = _build.function(_build.width_stem("insert", Fp.n32), "insert_v1",
                         _ARGS_V1)
    name = _build.width_name("K6 g1", Fp.n32)
    _build.launch(fn, f"{name} insert_v1", d.device, _build.ptr(off),
                  _build.ptr(ent), int(ent.dtype == torch.int32),
                  _build.ptr(rec), _ptr_array(lane),
                  *(_build.ptr(t) for t in raw), W, T, L, B, Fp.n32,
                  G._b3_host, Fp.p_c, Fp.one_c, Fp.inv32, d.get_device(),
                  _build.stream_ptr(d))
    _build.LAUNCHES[name] += 1
    return ProjectivePoint(*raw)


def lane_words(G) -> int:
    """The words of a bucket's coordinate in the chain kernels' lane-major
    scratch: its limbs padded to whole 32-byte sectors (8 on alt_bn128's
    G1, 16 on its G2 and at 12 limbs; insert.cuh lane_words)."""
    return -(-math.prod(G.F.el_shape) // 8) * 8


def _kernel_tensors(G, d, pts, B, k, out_shape):
    """What the chain kernel reads and writes: the sort's lists (launched
    here), the point records, the lane-major scratch (W, L, B,
    lane_words) that the chain kernel writes the raw buckets to, a
    bucket's limbs contiguous so that each thread's stores fill whole
    sectors, and the three outputs (*el, *out_shape): the raw buckets (W,
    B, L) or the lane totals (W, B, 1), all from torch.empty.  The caller
    holds them until the launch is queued."""
    W, _, L = d.shape
    off, ent = _bucket_lists(d, pts[3], B, k)

    def coords(shape):
        return [torch.empty(shape, dtype=torch.int32, device=d.device)
                for _ in range(3)]

    return (off, ent, point_records(G, pts),
            coords((W, L, B, lane_words(G))),
            coords(G.F.el_shape + out_shape))


def _ptr_array(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


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


def insert_from_lists_plain(G, lists, pts, B: int, entries: int,
                            kmul: str = "cios",
                            pair: bool = False) -> ProjectivePoint:
    """K2's chain walk as plain torch ops: the raw buckets (*el, W, B, L)
    from the sort's lists (off, ent) and the points, walked as the chain
    kernel walks them with `entries` (its kEntries) list entries a
    thread.  Each (window, lane) has S = ceil(T / entries) threads; thread
    s owns the buckets whose lists start in the s-th of S equal shares of
    the lane's list, and takes one entry a step: an accumulator that
    starts at the identity takes the madd of each entry and is stored when
    the entry's bucket changes.  Vectorised over the threads, one step at
    a time.  `pair`: the 12-limb G2 chain kernel, whose "thread" is a
    pair (fp2_pair.cuh's Fp2Pair, a coefficient a thread), each Fq2
    product as the pair's lazy sums (:class:`PairField2`, which raises
    where a sum breaks its bound)."""
    check_kmul(kmul)
    if pair:
        if G.F.el_ndim != 2 or kernel_nr(G.F) is None or kmul != "cios":
            raise NotImplementedError(
                "the pair chains run CIOS over the G2 branches' Fq2")
        F = PairField2(G.F.plain.B, G.F.nr)
    else:
        F = G.F.plain.with_kmul(kmul)
    ax = G.F.el_ndim - 1                                # the limb axis
    off, ent = lists
    W, L, T = ent.shape
    dev = ent.device
    S = max(1, -(-T // entries))
    off = off.long()
    n = off[..., B:]                                    # (W, L, 1)
    share = -(-n * torch.arange(S + 1, device=dev) // S)     # (W, L, S + 1)
    first = torch.searchsorted(off[..., :B].contiguous(), share)
    first[..., S] = B
    lo, hi = first[..., :-1], first[..., 1:]            # buckets [lo, hi)
    start, end = off.gather(-1, lo), off.gather(-1, hi)
    ends = off[..., 1:].contiguous()                    # (W, L, B)

    def identity(m):
        one = to16(G.F.one((W, L, m), dev), ax)
        return [torch.zeros_like(one), one, torch.zeros_like(one)]

    # bucket B is a slot where threads that store nothing write
    buckets = identity(B + 1)
    ident = acc = identity(S)                           # (0, 1, 0) a thread
    el16 = tuple(ident[1].shape[:ax + 1])
    lead = (None,) * len(el16)
    cur = lo                                            # the bucket held
    px, py, pneg = (to16(a, ax).reshape(el16 + (T * L,)) for a in pts[:3])
    lane = torch.arange(L, device=dev)[:, None]
    ent = ent.long()

    def store(mask):
        idx = torch.where(mask, cur, B).expand(el16 + (W, L, S))
        for b, a in zip(buckets, acc):
            b.scatter_(-1, idx, a)

    steps = int((end - start).max()) if start.numel() else 0
    for s in range(steps):
        i = start + s
        live = i < end
        b = torch.searchsorted(ends, i, right=True)    # the bucket of i
        new_bucket = live & (b != cur)
        store(new_bucket)
        acc = [torch.where(new_bucket[lead], z, a) for z, a in zip(ident, acc)]
        cur = torch.where(live, b, cur)
        e = ent.gather(-1, i.clamp(max=T - 1))
        p = (e >> 1) * L + lane
        qy = torch.where((e & 1).bool()[lead], pneg[..., p], py[..., p])
        new = fml.rcb_madd_a0(F, *acc, px[..., p], qy, G._b3_host)
        acc = [torch.where(live[lead], v, a) for v, a in zip(new, acc)]
    store(lo < hi)
    return ProjectivePoint(*(to32(b[..., :B].transpose(-1, -2), ax)
                             for b in buckets))
