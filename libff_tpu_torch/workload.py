"""The main path's workload: MSM inputs and their exact oracle.

As in bench.py:72-137: N scalars times N points, point i being
(i % 32 + 1) * gen, so the MSM equals (sum_j (j+1) * K_j mod r) * gen with
K_j the sum of the scalars of residue class j, one host scalar
multiplication however large N is.  The scalars here come from a numpy
seed (bench.py uses libff's SHA512 generator) and are held in the JAX
package's layout, (n16, N) uint32 plain 16-bit limbs; points come as
Montgomery 16-bit limbs.  ``convert.py`` turns both into the port's
tensors.  Those points repeat with period 32, so a kernel that reads the
wrong point of a residue class gives the same result on them; the
kernel checks use distinct points (``progression``) instead.
"""

from __future__ import annotations

import numpy as np

from libff_tpu.host import mont as hm


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
    """Host affine G1 points -> (x, y), each (n16, len(pts)) Montgomery
    16-bit limbs."""
    n16 = cd.fq.mp.n16

    def coord(j):
        return np.ascontiguousarray(np.array(
            [hm.int_to_limbs(hm.to_mont(cd.fq.mp, P[j]), n16) for P in pts],
            dtype=np.uint32).T)

    return coord(0), coord(1)


def progression(cd, start: int, step: int, n: int) -> list:
    """The host points (start + i * step) * gen for i < n, one affine
    addition each."""
    E, gen = cd.g1.curve, cd.g1.generator
    P, S = E.mul(start, gen), E.mul(step, gen)
    out = []
    for _ in range(n):
        out.append(P)
        P = E.add(P, S)
    return out


def msm_inputs(cd, n: int, seed: int):
    """(scalar_limbs, x, y): scalars < r as (n16, n) plain 16-bit limbs and
    the points' affine coordinates as (n16, n) Montgomery 16-bit limbs."""
    limbs = random_scalars(cd, n, np.random.default_rng(seed))
    E, gen = cd.g1.curve, cd.g1.generator
    x, y = affine_limbs(cd, [E.mul(i + 1, gen) for i in range(32)])
    cls = np.arange(n) % 32
    return (limbs, np.ascontiguousarray(x[:, cls]),
            np.ascontiguousarray(y[:, cls]))


def class_sums(limbs: np.ndarray) -> list[int]:
    """Exact per-residue-class scalar sums K_j = sum_{i%32==j} k_i from the
    (n16, n) plain 16-bit limbs (bench.py:113-124)."""
    n = limbs.shape[1]
    cls = (np.arange(n) % 32).astype(np.int64)
    out = []
    for j in range(32):
        part = limbs[:, cls == j].astype(np.uint64).sum(axis=1)
        out.append(sum(int(p) << (16 * l) for l, p in enumerate(part)))
    return out


def oracle(cd, sums: list[int]):
    """The exact MSM value sum_j (j+1) * K_j * gen as a host affine point,
    None for the identity (bench.py:127-137)."""
    total = 0
    for j, kj in enumerate(sums):
        total = (total + (j + 1) * kj) % cd.r
    return cd.g1.curve.mul(total, cd.g1.generator) if total else None
