"""The main paths' workloads: MSM inputs and their exact oracles.

G1 as in bench.py:72-137: N scalars times N points, point i being
(i % 32 + 1) * gen, so the MSM equals (sum_j (j+1) * K_j mod r) * gen with
K_j the sum of the scalars of residue class j, one host scalar
multiplication however large N is.  Nothing in it is alt_bn128's: the
same case and oracle serve the G1 of BLS12-381 and BLS12-377, with their
generators, r and scalar bits (``scalar_bits``).  G2 as in profile/bench_g2.py:49-85:
the same with period 16 and the G2 generator.  The scalars here come from
a numpy seed (the JAX package uses libff's SHA512 generator) and are held
in the JAX package's layout, (n16, N) uint32 plain 16-bit limbs; points
come as Montgomery 16-bit limbs, (n16, N) for G1 and (2, n16, N) for G2.
``convert.py`` turns both into the port's tensors; ``msm_case`` gives
the whole case, and ``run_msm`` runs it, for ``chip_smoke.py``, the sweep
and the profile.  Those points repeat with period 32 or 16, so a kernel
that reads the wrong point of a residue class gives the same result on
them; the kernel checks use distinct points (``progression``) instead.
K3's checks take random elements with edge lanes: ``k3_inputs`` for the
batched ops, ``scan_inputs`` for the Horner scan; the lane merge's take
``merge_inputs``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import convert
from .curves.group import ProjectivePoint
from .host import mont as hm
from .msm import digits as dig
from .msm.pippenger import _prepare, msm_pippenger

PERIOD = {"g1": 32, "g2": 16}
SEED = 2024
# the curves of the MSM paths: alt_bn128 at 8 limbs, the BLS12 pair at 12
CURVES = ("alt_bn128", "bls12_381", "bls12_377")


def curve_arg(argv: list[str]) -> tuple[str, list[str]]:
    """(the curve of a ``--curve CURVE`` option, alt_bn128 without one;
    the other arguments) of a script's argv; raises on a curve not in
    CURVES."""
    curve = "alt_bn128"
    if "--curve" in argv:
        i = argv.index("--curve")
        curve, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    if curve not in CURVES:
        raise ValueError(f"unknown curve {curve!r}; one of {CURVES}")
    return curve, argv


def rand_elements(F, n: int, rng, dev) -> torch.Tensor:
    """n canonical elements of field F (Fp or Fq2), (*el, n) on dev:
    random limbs under p's top limb in every coefficient."""
    B = F.prime_field
    k = F.el_shape[0] if F.el_ndim == 2 else 1
    limbs = rng.integers(0, 1 << 32, size=(k, B.n32, n), dtype=np.uint64)
    limbs[:, -1] = rng.integers(0, B.p_limbs[-1], size=(k, n), dtype=np.uint64)
    t = torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)
    return t.reshape(F.el_shape + (n,))


def merge_inputs(G, W: int, B: int, L: int, rng, dev):
    """Raw buckets (*el, W, B, L) for the lane merge: random canonical
    coordinates (the complete add needs no point on the curve), bucket 0
    of every window the identity (0, 1, 0) in every lane, and of the other
    lanes about one in eight the identity and one in eight at infinity
    with other coordinates, (X, Y, 0)."""
    F = G.F
    x, y, z = (rand_elements(F, W * B * L, rng, dev).reshape(
        F.el_shape + (W, B, L)) for _ in range(3))
    u = torch.from_numpy(rng.random((W, B, L))).to(dev)
    ident = u < 1 / 8
    ident[:, 0] = True
    inf = ~ident & (u < 1 / 4)
    zero, one = torch.zeros_like(x), F.one((W, B, L), dev)
    return ProjectivePoint(F.select(ident | inf, zero, x),
                           F.select(ident, one, y),
                           F.select(ident | inf, zero, z))


def edge_values(B) -> list[int]:
    """Plain values of prime field B at the edges of its arithmetic."""
    p, R = B.p, B.mp.R
    return sorted({0, 1, 2, p - 1, p - 2, (p - 1) // 2, R % p, p - R % p,
                   (1 << 32) - 1, (1 << 224) % p, p - (1 << 128)})


def k3_inputs(F, n: int, rng, dev):
    """Six coordinate arrays and a mask, random elements with edge lanes:
    P = 0, Q = 0, Q = P, Q = -P and Q = P in another Jacobian scaling."""
    c = [rand_elements(F, n, rng, dev) for _ in range(6)]
    x1, y1, z1, x2, y2, z2 = c
    w = rand_elements(F, 64, rng, dev)
    z1[..., 0:64] = 0                                 # P = 0
    z2[..., 64:128] = 0                               # Q = 0
    for k in range(3):                                # Q = P
        c[3 + k][..., 128:192] = c[k][..., 128:192]
    x2[..., 192:256], z2[..., 192:256] = x1[..., 192:256], z1[..., 192:256]
    y2[..., 192:256] = F.neg(y1[..., 192:256])        # Q = -P
    s = slice(256, 320)                               # Q = P scaled by w
    w2 = F.sqr(w)
    x2[..., s] = F.mul(x1[..., s], w2)
    y2[..., s] = F.mul(y1[..., s], F.mul(w2, w))
    z2[..., s] = F.mul(z1[..., s], w)
    q_inf = torch.zeros(n, dtype=torch.bool, device=dev)
    q_inf[64:128] = True
    q_inf[1024:1100] = True
    # mixed adds: P = (x w^2, y w^3, w) against the affine Q = (x, y) on
    # [256, 320) and Q = (x, -y) on [320, 384)
    ax, ay = x2.clone(), y2.clone()
    x1m, y1m, z1m = x1.clone(), y1.clone(), z1.clone()
    for sl, sign in ((s, 1), (slice(320, 384), -1)):
        ax[..., sl] = x1[..., sl]
        ay[..., sl] = y1[..., sl] if sign > 0 else F.neg(y1[..., sl])
        x1m[..., sl] = F.mul(x1[..., sl], w2)
        y1m[..., sl] = F.mul(y1[..., sl], F.mul(w2, w))
        z1m[..., sl] = w
    return c, (x1m, y1m, z1m, ax, ay), q_inf


def scan_inputs(F, W: int, rng, dev):
    """W window totals [X, Y, Z] for K3's scan, random elements with the
    identity (0, 1, 0) at windows 1 and W - 1 and repeated points: window
    5 repeats window 4, and window W - 2 repeats window 3 (where W
    allows)."""
    t = [rand_elements(F, W, rng, dev) for _ in range(3)]
    one = F.one((1,), dev)
    for w in {1 % W, W - 1}:
        t[0][..., w] = 0
        t[1][..., w:w + 1] = one
        t[2][..., w] = 0
    for w, src in ((5, 4), (W - 2, 3)):
        if src < w < W:
            for a in t:
                a[..., w] = a[..., src]
    return t


def random_scalars(cd, n: int, rng) -> np.ndarray:
    """n scalars < r as (n16, n) plain 16-bit limbs; 0, 1 and r-1 sit at
    indices 0..2 when n allows."""
    n16 = cd.fr.mp.n16
    limbs = rng.integers(0, 1 << 16, size=(n16, n), dtype=np.uint32)
    # a top limb below r's keeps every scalar below r
    top = cd.r >> (16 * (n16 - 1))
    limbs[n16 - 1] = rng.integers(0, top, size=n, dtype=np.uint32)
    for i, k in enumerate((0, 1, cd.r - 1)[:n]):
        limbs[:, i] = hm.int_to_limbs(k, n16)
    return limbs


def affine_limbs(cd, pts) -> tuple[np.ndarray, np.ndarray]:
    """Host affine points -> (x, y) as Montgomery 16-bit limbs, (n16,
    len(pts)) for G1 (int coordinates), (2, n16, len(pts)) for G2 (Fq2
    tuple coordinates)."""
    n16 = cd.fq.mp.n16

    def limbs(vals):
        return np.ascontiguousarray(np.array(
            [hm.int_to_limbs(hm.to_mont(cd.fq.mp, v), n16) for v in vals],
            dtype=np.uint32).T)

    def coord(j):
        if isinstance(pts[0][j], tuple):
            return np.stack([limbs([P[j][i] for P in pts]) for i in (0, 1)])
        return limbs([P[j] for P in pts])

    return coord(0), coord(1)


def progression(cd, start: int, step: int, n: int, group: str = "g1") -> list:
    """The host points (start + i * step) * gen for i < n, one affine
    addition each."""
    g = getattr(cd, group)
    E, gen = g.curve, g.generator
    P, S = E.mul(start, gen), E.mul(step, gen)
    out = []
    for _ in range(n):
        out.append(P)
        P = E.add(P, S)
    return out


def msm_inputs(cd, n: int, seed: int, group: str = "g1"):
    """(scalar_limbs, x, y): scalars < r as (n16, n) plain 16-bit limbs and
    the points' affine coordinates as Montgomery 16-bit limbs, point i
    being (i % PERIOD[group] + 1) * gen."""
    limbs = random_scalars(cd, n, np.random.default_rng(seed))
    g, period = getattr(cd, group), PERIOD[group]
    x, y = affine_limbs(cd, [g.curve.mul(i + 1, g.generator)
                             for i in range(period)])
    cls = np.arange(n) % period
    return (limbs, np.ascontiguousarray(x[..., cls]),
            np.ascontiguousarray(y[..., cls]))


def class_sums(limbs: np.ndarray, period: int = 32) -> list[int]:
    """Exact per-residue-class scalar sums K_j = sum_{i%period==j} k_i from
    the (n16, n) plain 16-bit limbs (bench.py:113-124)."""
    n = limbs.shape[1]
    cls = (np.arange(n) % period).astype(np.int64)
    out = []
    for j in range(period):
        part = limbs[:, cls == j].astype(np.uint64).sum(axis=1)
        out.append(sum(int(p) << (16 * l) for l, p in enumerate(part)))
    return out


def oracle(cd, sums: list[int], group: str = "g1"):
    """The exact MSM value sum_j (j+1) * K_j * gen as a host affine point,
    None for the identity (bench.py:127-137, bench_g2.py:76-80)."""
    total = 0
    for j, kj in enumerate(sums):
        total = (total + (j + 1) * kj) % cd.r
    g = getattr(cd, group)
    return g.curve.mul(total, g.generator) if total else None


def msm_case(dc, group: str, log2n: int, device="cuda", seed: int = SEED):
    """The MSM of `group` of device curve dc at 2^log2n points: (scalars,
    points, want), the scalars and points as the port's tensors on
    `device` and want the structured oracle's host affine point."""
    n = 1 << log2n
    limbs, x, y = msm_inputs(dc.cd, n, seed, group)
    el_ndim = getattr(dc, group).F.el_ndim
    scalars = convert.field_to_torch(limbs, device)
    points = convert.affine_to_torch((x, y, np.zeros(n, dtype=bool)), device,
                                     el_ndim)
    want = oracle(dc.cd, class_sums(limbs, PERIOD[group]), group)
    return scalars, points, want


def scalar_bits(G) -> int:
    """The bits of group G's scalars, its order's (the curve's Fr bits:
    254 for alt_bn128, 255 for BLS12-381, 253 for BLS12-377)."""
    return G.order.bit_length()


def run_msm(G, scalars, points, config=None, phases: bool = True):
    """One MSM through msm_pippenger and to_affine, the card synchronised
    at its end: (host affine result or None, host seconds, phase seconds).
    With phases the card is also synchronised after each phase and the
    phase seconds, to_affine's included, are recorded; else they are {}."""
    times: dict | None = {} if phases else None
    t0 = time.perf_counter()
    A = G.to_affine(msm_pippenger(G, scalars, points, scalar_bits(G),
                                  config=config, phase_times=times))
    if A.x.is_cuda:
        torch.cuda.synchronize(A.x.device)
    total = time.perf_counter() - t0
    if phases:
        times["to_affine"] = total - sum(times.values())
    got = None if bool(A.inf) else (G.F.to_host(A.x), G.F.to_host(A.y))
    return got, total, times or {}


def insert_inputs(G, scalars, points, cfg):
    """The insert's inputs on the MSM path under cfg: (d, pts, B), the
    signed digits (W, T, L), the prepared points and the bucket count."""
    W = dig.num_signed_digits(G.order, scalar_bits(G), cfg.c)
    s, pts, T, L = _prepare(G, scalars, points, cfg)
    d = dig.signed_digits(s, cfg.c, W).reshape(W, T, L)
    return d, pts, 1 << (cfg.c - 1)
