"""Time K2 under other constants of its sort and chain kernel on the card.

    python3 -m libff_tpu_torch.tune_insert [--against DIR]
        [NAME=V,NAME=V ...] ...

Each argument is one variant: macros of ``csrc/insert.cuh`` (``TUNABLES``)
set to other values, such as ``LFF_ENTRIES_G1=256,LFF_MIN_BLOCKS_G1=3``
(LFF_ENTRIES_G1 and LFF_ENTRIES_G2: the list entries a chain thread walks
on G1 and G2; LFF_MIN_BLOCKS_G1 and LFF_MIN_BLOCKS_G2:
``__launch_bounds__``'s blocks an SM; LFF_SORT_BLOCKS_PER_SM: the sort's
blocks an SM).  With no argument the variants are LFF_ENTRIES_G1 = 128,
256, 1024 beside LFF_ENTRIES_G2 = 64, 128, 512.  On the insert inputs of
the two MSM paths (alt_bn128 G1 at 2^20 points and G2 at 2^18, c = 8,
1024 lanes) it times ``insert`` (the sort, the point records and the
chain kernel), the sort alone and the point records, on the path's
digits and on even digits (step t of window w in bucket (t + w) mod B,
with the path's signs, so every thread walks as many entries as every
other), and holds each build's lists and raw buckets on both against the
package build's.  The rest (builds, ptxas figures, JSON lines,
``--against``) is :mod:`libff_tpu_torch.tune`'s.
"""

from __future__ import annotations

import sys

import torch

from . import tune, workload
from .curves.device import device_curve
from .msm.insert import bucket_lists, insert, point_records
from .msm.pippenger import default_config
from .timing import event_ms

TUNABLES = ("LFF_ENTRIES_G1", "LFF_ENTRIES_G2", "LFF_MIN_BLOCKS_G1",
            "LFF_MIN_BLOCKS_G2", "LFF_SORT_BLOCKS_PER_SM")
DEFAULT_VARIANTS = [{"LFF_ENTRIES_G1": g1, "LFF_ENTRIES_G2": g2}
                    for g1, g2 in ((128, 64), (256, 128), (1024, 512))]
PATHS = (("g1", 20), ("g2", 18))
REPS = 5


def even_digits(d: torch.Tensor, B: int) -> torch.Tensor:
    W, T, _ = d.shape
    t = torch.arange(T, device=d.device)[None, :, None]
    w = torch.arange(W, device=d.device)[:, None, None]
    mag = (1 + (t + w) % B).to(d.dtype)
    return torch.where(d < 0, -mag, mag)


def outputs(G, d, de, pts, B) -> list:
    return [a for x in (d, de)
            for out in (bucket_lists(G, x, pts[3], B), insert(G, x, pts, B))
            for a in out]


def cases(dev):
    dc = device_curve("alt_bn128")
    for group, log2n in PATHS:
        G = getattr(dc, group)
        scalars, points, _ = workload.msm_case(dc, group, log2n, dev)
        d, pts, B = workload.insert_inputs(G, scalars, points,
                                           default_config(1 << log2n, G,
                                                          dev))
        case = (G, d, even_digits(d, B), pts, B)
        yield ({"group": group, "shape": list(d.shape) + [B]}, case,
               outputs(*case))


def measure(case, rep):
    G, d, de, pts, B = case
    return ({"ms": event_ms(lambda: insert(G, d, pts, B), REPS),
             "even_ms": event_ms(lambda: insert(G, de, pts, B), REPS),
             "sort_ms": event_ms(lambda: bucket_lists(G, d, pts[3], B), 20),
             "records_ms": event_ms(lambda: point_records(G, pts), 20)},
            outputs(*case))


def main(argv) -> int:
    return tune.main("tune_insert", "insert", TUNABLES, argv, DEFAULT_VARIANTS,
                     cases, measure)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
