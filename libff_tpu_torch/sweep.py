"""Sweep the MSM configuration on the card.

    python3 -m libff_tpu_torch.sweep [g1|g2] [log2n] [c,c,...] [lanes,...]

For each window width c and lane count it runs the alt_bn128 MSM of the
given group (default G2 at 2^18 points, the G2 path of chip_smoke.py) on
the workload of ``workload.py``: one run to warm up, then ``RUNS`` timed
runs, each held against the structured oracle.  It prints one JSON line
per configuration (median seconds and the median of each phase), then the
card's name and power limit.  It needs a CUDA card and refuses to run
without one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from . import _build, workload
from .curves.device import device_curve
from .msm.pippenger import MsmConfig

RUNS = 3


def run(group: str, log2n: int, cs, lanes) -> None:
    dc = device_curve("alt_bn128")
    G = getattr(dc, group)
    scalars, points, want = workload.msm_case(dc, group, log2n)
    for c in cs:
        for L in lanes:
            cfg = MsmConfig(c=c, lanes=L)
            rows = []
            for i in range(1 + RUNS):
                got, total, times = workload.run_msm(G, scalars, points, cfg)
                if got != want:
                    raise RuntimeError(f"{cfg} disagrees with the oracle")
                if i:
                    rows.append({"seconds": total, **times})
            print(json.dumps({
                "group": group, "log2n": log2n, "c": c, "lanes": L,
                **{k: float(np.median([r[k] for r in rows]))
                   for k in rows[0]}}), flush=True)
            torch.cuda.empty_cache()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    group = argv[0] if argv else "g2"
    log2n = int(argv[1]) if len(argv) > 1 else 18
    cs = [int(v) for v in argv[2].split(",")] if len(argv) > 2 else \
        [6, 7, 8, 9, 10]
    lanes = [int(v) for v in argv[3].split(",")] if len(argv) > 3 else \
        [256, 512, 1024, 2048]
    run(group, log2n, cs, lanes)
    print(_build.card_name_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
