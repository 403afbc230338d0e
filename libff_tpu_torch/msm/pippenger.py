"""Signed-digit Pippenger MSM for complete (a = 0) groups (port of
libff_tpu/msm/pippenger.py, the signed complete path), over Fp (G1) and
Fq2 (G2).

BDLO12_signed (multiexp.tcc:507-641) with the JAX package's schedule: the
batch splits into L lanes of T = N/L points, each lane owning private
buckets for every window.

  digits : signed c-bit digits (W, T, L)                      torch ops
  insert : bucket |d|-1 += +-P, per (window, lane), in t order
           kernel K2 (engine "auto" or "pallas3"), K6 ("pallas", G1)
  merge  : the lane tree of the buckets, (W, B, L) -> (W, B, 1)
           kernel K5 (merge="kernel"), fused into K2 (merge=True)
  reduce : lane halving tree (merge=False), bucket suffix tree, sum tree
                                                                 kernel K3
  horner : window-parallel masked doubling, then a sum tree,
           one launch                                   kernel K3 (scan)
  finish : projective -> Jacobian                      kernel K1e (K4e on G2)

``MsmConfig`` has the JAX package's eight fields in its order
(pippenger.py:41-68).  ``engine``, ``merge`` and ``kmul`` have the JAX
package's meanings and routes (pippenger.py:520-540); every setting gives
the same buckets bit for bit, so the same result.  ``kmul`` ("cios",
"sos", "sos2") is the Montgomery product inside K2 and K5, as the JAX
package passes it to insert_pallas3 (pippenger.py:534); K3 and K6 stay on
CIOS there and here.  ``scatter`` and ``formulas`` are checked against
the JAX package's values and choose nothing yet: they select the XLA
path's bucket update and the formula VM, which ROADMAP Queue 1 item 18
ports.  ``tb`` (the TPU kernel's time rows per grid step) is accepted
and has no effect on the card.

The paths run on alt_bn128's G1 and G2 (8 limbs) and on the G1 and G2
of BLS12-381 and BLS12-377 (12 limbs), every setting on each, each width
from its own kernel libraries (``_build.width_stem``).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..curves.group import (AffinePoint, Group, JacobianPoint,
                            ProjectivePoint)
from ..curves.group_ops import horner_scan
from ..fields.fp import KMULS
from . import digits as dig
from .insert import insert, insert_v1
from .merge import merge_lanes

ENGINES = ("auto", "pallas3", "pallas", "xla")
MERGES = (False, "kernel", True)
SCATTERS = ("select", "gather")
FORMULAS = ("auto", "direct", "vm")


class MsmConfig(NamedTuple):
    c: int        # signed-digit window width
    lanes: int    # number of independent bucket lanes (a power of two)
    scatter: str = "select"    # the XLA path's bucket update, "select" or
                               # "gather": checked, acts with ROADMAP
                               # Queue 1 item 18
    engine: str = "auto"       # insert kernel: "auto" or "pallas3" (K2),
                               # "pallas" (K6, the v1 insert, G1 only);
                               # "xla" waits for ROADMAP Queue 1 item 18
    formulas: str = "auto"     # the formula engine, "auto", "direct" or
                               # "vm": checked, acts with item 18
    merge: bool | str = False  # lane merge: False = K3's halving tree in
                               # the reduce, "kernel" = K5 after the
                               # insert, True = fused into K2 (lanes a
                               # multiple of 128)
    tb: int = 16               # the TPU kernel's time rows per grid step:
                               # accepted, no effect on the card
    kmul: str = "cios"         # Montgomery product in K2 and K5: "cios",
                               # "sos", "sos2" (engine "pallas": CIOS only)


def default_config(n: int, G: Group | None = None,
                   device="cuda") -> MsmConfig:
    """Window and lane choice by device and size (called as the JAX
    package's ``default_config(n, G)``; the group may steer the choice,
    and today it does not).

    CUDA: the insert sorts each (window, lane)'s steps by bucket and
    walks the bucket chains, so its time follows the number of mixed adds
    more than the lanes; the lanes set the size of the bucket array and
    of the lane merge in the reduce.  A sweep on an H100 (``python3 -m
    libff_tpu_torch.sweep``, c in 7..9, lanes in 256..2048) found c = 8
    the fastest on both paths, G1 at 2^20 points and G2 at 2^18.  With
    Horner and to_affine's inverse one launch each, no longer host time
    that varied more between runs than two settings differ, a sweep of
    256 against 1024 lanes found G2 faster at 256 (a shorter lane merge
    in the reduce) and left G1 unresolved, 256 ahead in one of three
    pairs (PERF.md §6-§7).  Both groups keep 1024 lanes, and so do the
    12-limb G1s of BLS12-381 and BLS12-377, which no sweep has measured.
    Smaller sizes were not swept; ``_prepare`` cuts the lanes to the
    largest power of two <= n.
    CPU (the plain versions, tests): small windows keep the plain insert's
    gather and the bucket arrays small.
    """
    if torch.device(device).type == "cuda":
        return MsmConfig(c=8, lanes=1024)
    if n >= 1 << 12:
        return MsmConfig(c=6, lanes=128)
    if n >= 64:
        return MsmConfig(c=4, lanes=32)
    return MsmConfig(c=3, lanes=1)


def _prepare(G: Group, scalar_limbs, points: AffinePoint, cfg: MsmConfig):
    """Pad to a lane multiple and reshape into (T, L) steps x lanes; pneg
    holds the negated y for the signed-digit bucket trick
    (pippenger.py:119-143)."""
    if cfg.lanes < 1 or cfg.lanes & (cfg.lanes - 1):
        raise ValueError(f"lanes must be a power of two, not {cfg.lanes}")
    F = G.F
    N = scalar_limbs.shape[-1]
    L = min(cfg.lanes, 1 << (N.bit_length() - 1))
    T = -(-N // L)
    pad = T * L - N
    x, y, inf = points
    if pad:
        def zpad(a):
            return torch.cat([a, a.new_zeros(a.shape[:-1] + (pad,))], dim=-1)

        scalar_limbs, x, y = zpad(scalar_limbs), zpad(x), zpad(y)
        inf = torch.cat([inf, inf.new_ones((pad,))])
    shape = F.el_shape + (T, L)
    px = x.reshape(shape)
    py = y.reshape(shape)
    pneg = F.neg(y).reshape(shape)
    pinf = inf.reshape(T, L)
    return scalar_limbs, (px, py, pneg, pinf), T, L


def _shift_down(G: Group, P: ProjectivePoint, k: int, axis: int
                ) -> ProjectivePoint:
    """P'_b = P_(b+k) along `axis`, the tail padded with identities."""
    el = G.F.el_ndim
    n = P.z.shape[axis]
    pad = list(P.z.shape[el:])
    pad[axis - el] = k
    zero = G.proj_zero(tuple(pad), P.z.device)
    return ProjectivePoint(*(torch.cat([a.narrow(axis, k, n - k), z], dim=axis)
                             for a, z in zip(P, zero)))


def _halve_lanes(G: Group, buckets: ProjectivePoint) -> ProjectivePoint:
    """The lane merge as a halving tree of batched padds on K3: (W, B, L)
    -> (W, B, 1); nothing to do when L is 1 (a merged insert)."""
    while buckets.z.shape[-1] > 1:
        half = buckets.z.shape[-1] // 2
        buckets = G.padd(
            ProjectivePoint(*(a[..., :half] for a in buckets)),
            ProjectivePoint(*(a[..., half:2 * half] for a in buckets)))
    return buckets


def _reduce_buckets(G: Group, buckets: ProjectivePoint, B: int
                    ) -> ProjectivePoint:
    """Lane merge + bucket suffix reduction of a (W, B, L) bucket array
    (pippenger.py:376-398).  Returns sum_b (b+1) * B_b per window, (W,)."""
    buckets = _halve_lanes(G, buckets)
    s = ProjectivePoint(*(a[..., 0] for a in buckets))      # batch (W, B)
    # suffix sums s_b = sum_{b' >= b} B_b' by a log-depth shift tree; then
    # sum_b s_b = sum_b (b+1) B_b  (multiexp.tcc:90-125)
    k = 1
    while k < B:
        s = G.padd(s, _shift_down(G, s, k, axis=s.z.ndim - 1))
        k *= 2
    return G.proj_sum_tree(s, axis=-1)


def _horner_complete(G: Group, totals: ProjectivePoint, c: int
                     ) -> ProjectivePoint:
    """sum_w 2^(c*w) * totals_w by window-parallel masked doubling: c*(W-1)
    batched doublings in which window w takes part while k < c*w, then a
    log-depth sum tree (pippenger.py:419-433), as one launch of K3's scan
    entry on the card (group_ops.horner_scan)."""
    return ProjectivePoint(*horner_scan(G, list(totals), c))


def window_totals_v1(G: Group, d: torch.Tensor, pts, B: int
                     ) -> ProjectivePoint:
    """The v1 insert (K6) + lane merge + bucket suffix tree: per-window
    totals, (W,) (pallas_insert.py:265-272)."""
    return _reduce_buckets(G, insert_v1(G, d, pts, B), B)


def _check_config(G: Group, cfg: MsmConfig) -> None:
    """The settings the port runs (pippenger.py:520-540), on every group
    the kernels take at either width, or raise: an unknown scatter or
    formulas value (pippenger.py:41-68); "xla" is still to port (ROADMAP
    Queue 1 item 18); "pallas" is G1 only and has no lane merge and no
    product but CIOS (the JAX package would ignore either silently, and
    would run an unknown kmul as CIOS, pallas_insert.py:98-99)."""
    if cfg.engine not in ENGINES:
        raise ValueError(f"unknown engine {cfg.engine!r}; one of {ENGINES}")
    if cfg.scatter not in SCATTERS:
        raise ValueError(f"unknown scatter {cfg.scatter!r}; one of "
                         f"{SCATTERS}")
    if cfg.formulas not in FORMULAS:
        raise ValueError(f"unknown formulas {cfg.formulas!r}; one of "
                         f"{FORMULAS}")
    if not (isinstance(cfg.merge, bool) or cfg.merge == "kernel"):
        raise ValueError(f"unknown merge {cfg.merge!r}; one of {MERGES}")
    if cfg.kmul not in KMULS:
        raise ValueError(f"unknown kmul {cfg.kmul!r}; one of {KMULS}")
    if cfg.engine == "xla":
        raise NotImplementedError(
            "the XLA insert engine waits for ROADMAP Queue 1 item 18")
    if cfg.engine == "pallas":
        if G.F.el_ndim != 1:
            raise ValueError("engine 'pallas' (the v1 insert) is G1 only")
        if cfg.merge is not False:
            raise ValueError("engine 'pallas' has no lane merge; use "
                             "engine 'pallas3' for merge "
                             f"{cfg.merge!r}")
        if cfg.kmul != "cios":
            raise ValueError("engine 'pallas' runs the CIOS product only; "
                             f"use engine 'pallas3' for kmul {cfg.kmul!r}")


class _PhaseClock:
    """Records host seconds per phase into `times` after synchronizing the
    card; does nothing when `times` is None."""

    def __init__(self, times: dict | None, device: torch.device):
        self.times, self.cuda = times, device.type == "cuda"
        self._sync()
        self.t = time.perf_counter()

    def _sync(self):
        if self.times is not None and self.cuda:
            torch.cuda.synchronize()

    def __call__(self, name: str):
        if self.times is None:
            return
        self._sync()
        now = time.perf_counter()
        self.times[name] = now - self.t
        self.t = now


def msm_pippenger(G: Group, scalar_limbs: torch.Tensor, points: AffinePoint,
                  num_bits: int, *, config: MsmConfig | None = None,
                  signed: bool = True,
                  phase_times: dict | None = None) -> JacobianPoint:
    """Multi-scalar multiplication sum_i scalars[i] * points[i].

    scalar_limbs: (n32, N) plain-form int32 limbs, values < the group order.
    points: affine batch of N points (infinity allowed via the mask).
    num_bits: bit width of the scalar field.
    config: window, lanes, insert engine, lane merge and in-kernel
    Montgomery product (MsmConfig).
    phase_times: when a dict, the card is synchronized after each phase
    and its host seconds are recorded (digits, insert, merge with
    merge="kernel", reduce, horner, finish).
    """
    if not signed:
        raise NotImplementedError(
            "the unsigned path waits for ROADMAP Queue 1 item 13")
    if not G.supports_complete:
        raise NotImplementedError(
            "the non-complete Jacobian path waits for ROADMAP Queue 1 item 10")
    N = scalar_limbs.shape[-1]
    cfg = config or default_config(N, G, scalar_limbs.device)
    _check_config(G, cfg)
    c = cfg.c
    W = dig.num_signed_digits(G.order, num_bits, c)
    B = 1 << (c - 1)
    clock = _PhaseClock(phase_times, scalar_limbs.device)
    scalar_limbs, pts, T, L = _prepare(G, scalar_limbs, points, cfg)
    d = dig.signed_digits(scalar_limbs, c, W).reshape(W, T, L)
    clock("digits")
    if cfg.engine == "pallas":
        buckets = insert_v1(G, d, pts, B)
    else:
        buckets = insert(G, d, pts, B, merge=cfg.merge is True,
                         kmul=cfg.kmul)
    clock("insert")
    if cfg.merge == "kernel":
        buckets = merge_lanes(G, buckets, cfg.kmul)
        clock("merge")
    totals = _reduce_buckets(G, buckets, B)
    clock("reduce")
    res = _horner_complete(G, totals, c)
    clock("horner")
    out = G.proj_to_jacobian(res)
    clock("finish")
    return out


def msm_pippenger_windows(*args, **kwargs):
    """Window-parallel partial MSM (pippenger.py:585-614)."""
    raise NotImplementedError(
        "msm_pippenger_windows waits for ROADMAP Queue 1 items 13 and 15")
