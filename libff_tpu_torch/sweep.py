"""Sweep the MSM configuration on the card.

    python3 -m libff_tpu_torch.sweep [--curve CURVE] [g1|g2] [log2n]
        [c,c,...] [lanes,...] [merge,...]

For each window width c, lane count and lane merge (``MsmConfig.merge``:
False, the default, leaves the lane tree to the reduce; "kernel" runs
K5; True K2m; default False alone) it runs the MSM of the given curve
(alt_bn128 by default; bls12_381 or bls12_377, the 12-limb paths;
bw6_761, the 24-limb ones) and
group (default G2 at 2^18 points, the G2 path of chip_smoke.py) on the
workload of ``workload.py``: one run to warm up, then ``RUNS`` timed
runs, each held against the structured oracle.  It prints one JSON line
per configuration (median seconds and the median of each phase), then the
card's name and power limit.  It needs a CUDA card and refuses to run
without one.
"""

from __future__ import annotations

import itertools
import json
import sys

import numpy as np
import torch

from . import _build, workload
from .curves.device import device_curve
from .msm.pippenger import MsmConfig

RUNS = 3
MERGES = {"False": False, "kernel": "kernel", "True": True}


def run(group: str, log2n: int, cs, lanes, merges=(False,),
        curve: str = "alt_bn128") -> None:
    dc = device_curve(curve)
    G = getattr(dc, group)
    scalars, points, want = workload.msm_case(dc, group, log2n)
    for c, L, merge in itertools.product(cs, lanes, merges):
        cfg = MsmConfig(c=c, lanes=L, merge=merge)
        rows = []
        for i in range(1 + RUNS):
            got, total, times = workload.run_msm(G, scalars, points, cfg)
            if got != want:
                raise RuntimeError(f"{cfg} disagrees with the oracle")
            if i:
                rows.append({"seconds": total, **times})
        print(json.dumps({
            "curve": curve, "group": group, "log2n": log2n, "c": c,
            "lanes": L,
            "lane_merge": merge,
            **{k: float(np.median([r[k] for r in rows])) for k in rows[0]}}),
            flush=True)
        torch.cuda.empty_cache()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    curve, argv = workload.curve_arg(argv)
    group = argv[0] if argv else "g2"
    log2n = int(argv[1]) if len(argv) > 1 else 18
    cs = [int(v) for v in argv[2].split(",")] if len(argv) > 2 else \
        [6, 7, 8, 9, 10]
    lanes = [int(v) for v in argv[3].split(",")] if len(argv) > 3 else \
        [256, 512, 1024, 2048]
    merges = [MERGES[v] for v in argv[4].split(",")] if len(argv) > 4 else \
        [False]
    run(group, log2n, cs, lanes, merges, curve)
    print(_build.card_name_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
