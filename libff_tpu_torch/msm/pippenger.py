"""Signed-digit Pippenger MSM for complete (a = 0) groups (port of
libff_tpu/msm/pippenger.py, the signed complete path), over Fp (G1) and
Fq2 (G2).

BDLO12_signed (multiexp.tcc:507-641) with the JAX package's schedule: the
batch splits into L lanes of T = N/L points, each lane owning private
buckets for every window.

  digits : signed c-bit digits (W, T, L)                      torch ops
  insert : bucket |d|-1 += +-P, per (window, lane), in t order  kernel K2
  reduce : lane halving tree, bucket suffix tree, sum tree       kernel K3
  horner : window-parallel masked doubling, then a sum tree      kernel K3
  finish : projective -> Jacobian                      kernel K1e (K4e on G2)

The JAX package's TPU-only knobs (engine, formulas, merge, tb, kmul,
scatter) choose among TPU schedules and have no counterpart here.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..curves.group import (AffinePoint, Group, JacobianPoint,
                            ProjectivePoint)
from . import digits as dig
from .insert import insert


class MsmConfig(NamedTuple):
    c: int        # signed-digit window width
    lanes: int    # number of independent bucket lanes (a power of two)


def default_config(n: int, device) -> MsmConfig:
    """Window and lane choice by device and size.

    CUDA: lanes * windows threads run the insert, each walking n / lanes
    points, so the lanes trade parallelism against the size of the bucket
    array and of the reduce tree.  At 2^20 points a sweep on an H100 over
    c in 7..12 and lanes in 256..4096 found the insert near 60-75 ms
    everywhere and the whole MSM within a few per cent from 256 to 1024
    lanes at c = 7..9; c = 8 with 1024 lanes is among the fastest.  On G2
    at 2^18 points a sweep over c in 6..10 and lanes in 256..2048
    (``python3 -m libff_tpu_torch.sweep``) found c = 8 with 1024 lanes the
    fastest too, so both groups share the setting (PERF.md).
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


def _reduce_buckets(G: Group, buckets: ProjectivePoint, B: int
                    ) -> ProjectivePoint:
    """Lane merge + bucket suffix reduction of a (W, B, L) bucket array
    (pippenger.py:376-398).  Returns sum_b (b+1) * B_b per window, (W,)."""
    while buckets.z.shape[-1] > 1:
        half = buckets.z.shape[-1] // 2
        buckets = G.padd(
            ProjectivePoint(*(a[..., :half] for a in buckets)),
            ProjectivePoint(*(a[..., half:2 * half] for a in buckets)))
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
    log-depth sum tree (pippenger.py:419-433)."""
    W = totals.z.shape[-1]
    thresh = c * torch.arange(W, device=totals.z.device)
    P = totals
    for k in range(c * (W - 1)):
        P = G.select(k < thresh, G.pdbl(P), P)
    return G.proj_sum_tree(P, axis=-1)


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
    phase_times: when a dict, the card is synchronized after each phase
    and its host seconds are recorded (digits, insert, reduce, horner,
    finish).
    """
    if not signed:
        raise NotImplementedError(
            "the unsigned path waits for ROADMAP Queue 1 item 13")
    if not G.supports_complete:
        raise NotImplementedError(
            "the non-complete Jacobian path waits for ROADMAP Queue 1 item 10")
    N = scalar_limbs.shape[-1]
    cfg = config or default_config(N, scalar_limbs.device)
    c = cfg.c
    W = dig.num_signed_digits(G.order, num_bits, c)
    B = 1 << (c - 1)
    clock = _PhaseClock(phase_times, scalar_limbs.device)
    scalar_limbs, pts, T, L = _prepare(G, scalar_limbs, points, cfg)
    d = dig.signed_digits(scalar_limbs, c, W).reshape(W, T, L)
    clock("digits")
    buckets = insert(G, d, pts, B)
    clock("insert")
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
