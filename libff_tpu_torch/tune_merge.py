"""Time K5, the lane merge, under other constants of ``csrc/merge.cuh``.

    python3 -m libff_tpu_torch.tune_merge [--curve CURVE] [--against DIR]
        [NAME=V,NAME=V ...] ...

Each argument is one variant: macros of ``csrc/merge.cuh`` (``TUNABLES``)
set to other values, such as ``LFF_K5_MIN_BLOCKS_G2=14``
(``__launch_bounds__``'s blocks an SM, one warp each, of the G1 kernel
and of the G2 kernel over pairs of threads; at 12 limbs
``LFF_K5_MIN_BLOCKS_G1_N12`` and ``..._G2_N12``; the slots a thread keeps
in shared memory follow them).  ``--curve`` picks the
curve (``workload.CURVES``: alt_bn128, the default, builds
``csrc/merge.cu``; bls12_381 and bls12_377 ``csrc/merge_n12.cu``).  With no variant it runs
``DEFAULT_VARIANTS`` of the curve's width.  At the MSM paths' shape (W =
32 windows of B = 128 buckets, 1024 lanes) it times ``merge_lanes`` on G1
and G2, on two inputs each: "random", ``workload.merge_inputs`` (a
quarter of the lanes the identity or at infinity), and "path", K2's raw
buckets on the MSM workload (G1 at 2^20 points, G2 at 2^18), in two
passes, the first also with the SM clock that nvidia-smi reads while the
kernel runs.  The package build's totals are held against
``merge_lanes_plain``.  The rest (builds, ptxas figures of the lane tree,
JSON lines, ``--against``) is :mod:`libff_tpu_torch.tune`'s.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from . import _build, tune, workload
from .curves.device import device_curve
from .msm.insert import insert
from .msm.merge import merge_lanes, merge_lanes_plain
from .msm.pippenger import default_config
from .timing import clock_under_load, event_ms

TUNABLES = ("LFF_K5_MIN_BLOCKS_G1", "LFF_K5_MIN_BLOCKS_G2",
            "LFF_K5_MIN_BLOCKS_G1_N12", "LFF_K5_MIN_BLOCKS_G2_N12")
DEFAULT_VARIANTS = {
    8: [{"LFF_K5_MIN_BLOCKS_G1": 12, "LFF_K5_MIN_BLOCKS_G2": 12}],
    12: [{"LFF_K5_MIN_BLOCKS_G1_N12": b, "LFF_K5_MIN_BLOCKS_G2_N12": b}
         for b in (8, 10, 16)]}
SHAPE = (32, 128, 1024)          # W, B, L of both MSM paths at c = 8
PATHS = {"g1": 20, "g2": 18}     # log2 of each MSM path's points
REPS = 10


def cases(dev, curve="alt_bn128"):
    dc = device_curve(curve)
    rng = np.random.default_rng(10)
    for group, log2n in PATHS.items():
        G = getattr(dc, group)
        scalars, points, _ = workload.msm_case(dc, group, log2n, dev)
        d, pts, B = workload.insert_inputs(
            G, scalars, points, default_config(1 << log2n, G, dev))
        for inputs, raw in (("random", workload.merge_inputs(G, *SHAPE, rng,
                                                              dev)),
                            ("path", insert(G, d, pts, B))):
            if tuple(raw.z.shape[-3:]) != SHAPE:
                raise RuntimeError(f"the {group} path's buckets are not "
                                   f"{SHAPE}")
            want = list(merge_lanes(G, raw))
            if not all(torch.equal(a, b)
                       for a, b in zip(want, merge_lanes_plain(G, raw))):
                raise RuntimeError(f"K5 disagrees with merge_lanes_plain on "
                                   f"{group} {inputs}")
            yield ({"group": group, "inputs": inputs, "shape": list(SHAPE)},
                   (G, raw), want)


def measure(case, rep):
    G, raw = case
    times = {"ms": event_ms(lambda: merge_lanes(G, raw), REPS)}
    if rep == 0:  # the SM clock nvidia-smi reads meanwhile
        times["sm_clock_mhz"] = clock_under_load(lambda: merge_lanes(G, raw))
    return times, list(merge_lanes(G, raw))


def main(argv) -> int:
    curve, argv = workload.curve_arg(argv)
    n32 = device_curve(curve).fq.n32
    return tune.main("tune_merge", _build.width_stem("merge", n32), TUNABLES,
                     argv, DEFAULT_VARIANTS[n32],
                     functools.partial(cases, curve=curve), measure,
                     passes=2, ptxas=_build.tree_kernels)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
