"""The main paths' workloads: MSM inputs and their exact oracles.

G1 as in bench.py:72-137: N scalars times N points, point i being
(i % 32 + 1) * gen, so the MSM equals (sum_j (j+1) * K_j mod r) * gen with
K_j the sum of the scalars of residue class j, one host scalar
multiplication however large N is.  G2 as in profile/bench_g2.py:49-85:
the same with period 16 and the G2 generator.  The scalars here come from
a numpy seed (the JAX package uses libff's SHA512 generator) and are held
in the JAX package's layout, (n16, N) uint32 plain 16-bit limbs; points
come as Montgomery 16-bit limbs, (n16, N) for G1 and (2, n16, N) for G2.
``convert.py`` turns both into the port's tensors; ``msm_case`` gives
the whole case, and ``run_msm`` runs it, for ``chip_smoke.py``, the sweep
and the profile.  Those points repeat with period 32 or 16, so a kernel
that reads the wrong point of a residue class gives the same result on
them; the kernel checks use distinct points (``progression``) instead.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import convert
from .host import mont as hm
from .msm.pippenger import msm_pippenger

PERIOD = {"g1": 32, "g2": 16}
SEED = 2024


def rand_elements(F, n: int, rng, dev) -> torch.Tensor:
    """n canonical elements of field F (Fp or Fq2), (*el, n) on dev:
    random limbs under p's top limb in every coefficient."""
    B = F.prime_field
    k = F.el_shape[0] if F.el_ndim == 2 else 1
    limbs = rng.integers(0, 1 << 32, size=(k, B.n32, n), dtype=np.uint64)
    limbs[:, -1] = rng.integers(0, B.p_limbs[-1], size=(k, n), dtype=np.uint64)
    t = torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)
    return t.reshape(F.el_shape + (n,))


def edge_values(B) -> list[int]:
    """Plain values of prime field B at the edges of its arithmetic."""
    p, R = B.p, B.mp.R
    return sorted({0, 1, 2, p - 1, p - 2, (p - 1) // 2, R % p, p - R % p,
                   (1 << 32) - 1, (1 << 224) % p, p - (1 << 128)})


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


def run_msm(G, scalars, points, config=None, phases: bool = True):
    """One MSM through msm_pippenger and to_affine, the card synchronised
    at its end: (host affine result or None, host seconds, phase seconds).
    With phases the card is also synchronised after each phase and the
    phase seconds, to_affine's included, are recorded; else they are {}."""
    times: dict | None = {} if phases else None
    t0 = time.perf_counter()
    A = G.to_affine(msm_pippenger(G, scalars, points, 254, config=config,
                                  phase_times=times))
    if A.x.is_cuda:
        torch.cuda.synchronize(A.x.device)
    total = time.perf_counter() - t0
    if phases:
        times["to_affine"] = total - sum(times.values())
    got = None if bool(A.inf) else (G.F.to_host(A.x), G.F.to_host(A.y))
    return got, total, times or {}
