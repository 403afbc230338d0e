"""Time K2 under other constants of its sort and chain kernels on the card.

    python3 -m libff_tpu_torch.tune_insert [--against DIR[:NAME=V,...]]
        [NAME=V,NAME=V ...] ...

Each argument is one variant: macros of ``csrc/insert.cuh`` (``TUNABLES``)
set to other values, such as ``LFF_ENTRIES_G1_N12=512,
LFF_MIN_BLOCKS_G1_N12=4``.  LFF_ENTRIES_G1, LFF_ENTRIES_G2 and
LFF_ENTRIES_G1_N12: the list entries a chain thread walks on G1 at 8 and
at 12 limbs and on G2; LFF_MIN_BLOCKS_G1, LFF_MIN_BLOCKS_G2 and
LFF_MIN_BLOCKS_G1_N12: ``__launch_bounds__``'s blocks an SM;
LFF_SORT_TILE: the steps of a lane the sort holds in shared memory;
LFF_SORT_WARPS: the sort's warps a block, which share its 32 lanes.  A
variant builds both K2 sources, ``insert.cu`` (8 limbs, and the sort) and
``insert_n12.cu`` (12 limbs).  With no argument the variants are
DEFAULT_VARIANTS.  On the insert inputs of the three G1 paths and the G2
path (alt_bn128 G1 and BLS12-381 G1 at 2^20 points, alt_bn128 G2 at 2^18,
``default_config``: c = 8, 1024 lanes) it times ``insert`` (the sort,
the point records and the chain kernel), the sort alone and the point
records, on the path's digits, on even digits (step t of window w in
bucket (t + w) mod B, with the path's signs, so every thread walks as
many entries as every other and the chains of a warp end together) and
on shuffled digits (the even digits of each (window, lane) in a random
order of steps: the same chains, the points read in random order), and
holds each build's lists and raw buckets on all three against the
package build's.  The rest (builds, ptxas
figures, JSON lines, ``--against``) is :mod:`libff_tpu_torch.tune`'s.
"""

from __future__ import annotations

import sys

import torch

from . import tune, workload
from .curves.device import device_curve
from .msm.insert import bucket_lists, insert, point_records
from .msm.pippenger import default_config
from .timing import event_ms

STEMS = ("insert", "insert_n12")
TUNABLES = ("LFF_ENTRIES_G1", "LFF_ENTRIES_G2", "LFF_MIN_BLOCKS_G1",
            "LFF_MIN_BLOCKS_G2", "LFF_ENTRIES_G1_N12",
            "LFF_MIN_BLOCKS_G1_N12", "LFF_SORT_TILE", "LFF_SORT_WARPS")
# the 12-limb chain kernel at 4 and 2 blocks an SM, each with a share of
# a lane that fills whole waves at the path's shape; the sort at 8 warps
# a block
DEFAULT_VARIANTS = [{"LFF_MIN_BLOCKS_G1_N12": 4, "LFF_ENTRIES_G1_N12": 512},
                    {"LFF_MIN_BLOCKS_G1_N12": 2, "LFF_ENTRIES_G1_N12": 256},
                    {"LFF_SORT_WARPS": 8}]
PATHS = (("alt_bn128", "g1", 20), ("alt_bn128", "g2", 18),
         ("bls12_381", "g1", 20))
REPS = 5


def even_digits(d: torch.Tensor, B: int) -> torch.Tensor:
    W, T, _ = d.shape
    t = torch.arange(T, device=d.device)[None, :, None]
    w = torch.arange(W, device=d.device)[:, None, None]
    mag = (1 + (t + w) % B).to(d.dtype)
    return torch.where(d < 0, -mag, mag)


def shuffled_digits(de: torch.Tensor, seed: int = 5) -> torch.Tensor:
    """`de` with each (window, lane)'s steps in a random order: the same
    lists' lengths as even digits, the points read in random order."""
    g = torch.Generator(device=de.device).manual_seed(seed)
    perm = torch.rand(de.shape, generator=g, device=de.device).argsort(1)
    return de.gather(1, perm)


def outputs(G, d, de, ds, pts, B) -> list:
    return [a for x in (d, de, ds)
            for out in (bucket_lists(G, x, pts[3], B), insert(G, x, pts, B))
            for a in out]


def cases(dev):
    for curve, group, log2n in PATHS:
        dc = device_curve(curve)
        G = getattr(dc, group)
        scalars, points, _ = workload.msm_case(dc, group, log2n, dev)
        d, pts, B = workload.insert_inputs(G, scalars, points,
                                           default_config(1 << log2n, G,
                                                          dev))
        del scalars, points
        de = even_digits(d, B)
        case = (G, d, de, shuffled_digits(de), pts, B)
        yield ({"curve": curve, "group": group,
                "shape": list(d.shape) + [B]}, case, outputs(*case))


def measure(case, rep):
    G, d, de, ds, pts, B = case
    return ({"ms": event_ms(lambda: insert(G, d, pts, B), REPS),
             "even_ms": event_ms(lambda: insert(G, de, pts, B), REPS),
             "shuffled_ms": event_ms(lambda: insert(G, ds, pts, B), REPS),
             "sort_ms": event_ms(lambda: bucket_lists(G, d, pts[3], B), 20),
             "records_ms": event_ms(lambda: point_records(G, pts), 20)},
            outputs(*case))


def main(argv) -> int:
    return tune.main("tune_insert", STEMS, TUNABLES, argv, DEFAULT_VARIANTS,
                     cases, measure)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
