"""Where the MSM's time goes on the card: a torch.profiler trace of one
steady run.

    python3 -m libff_tpu_torch.profile_msm [g1|g2] [log2n]

It runs the alt_bn128 MSM of the group (default G2 at 2^18 points) twice
to warm up, then once under ``torch.profiler`` with CPU and CUDA
activities, and prints one JSON line: the run's wall milliseconds, the
device milliseconds summed over every kernel and copy (one stream, so
they do not overlap), the device idle share of the wall time, and the
device milliseconds and count of each kernel name; then the card's name
and power limit.  It needs a CUDA card and refuses to run without one.
"""

from __future__ import annotations

import json
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from . import _build, workload
from .curves.device import device_curve


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_msm: needs a CUDA card", file=sys.stderr)
        return 2
    group = argv[0] if argv else "g2"
    log2n = int(argv[1]) if len(argv) > 1 else 18
    dc = device_curve("alt_bn128")
    G = getattr(dc, group)
    scalars, points, want = workload.msm_case(dc, group, log2n)

    def msm():
        got, total, _ = workload.run_msm(G, scalars, points, phases=False)
        if got != want:
            raise RuntimeError("the MSM disagrees with the oracle")
        return total

    for _ in range(2):
        msm()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = msm() * 1e3
    kernels = {}
    for ev in prof.key_averages():
        # the device's own rows (kernels, copies); a torch op's row repeats
        # the time of the kernels it launched
        if ev.device_type.name == "CUDA" and ev.self_device_time_total > 0:
            kernels[ev.key] = {"ms": ev.self_device_time_total / 1e3,
                               "count": ev.count}
    device_ms = sum(k["ms"] for k in kernels.values())
    print(json.dumps({
        "group": group, "log2n": log2n, "wall_ms": wall_ms,
        "device_ms": device_ms, "idle_share": 1 - device_ms / wall_ms,
        "kernels": dict(sorted(kernels.items(),
                               key=lambda kv: -kv[1]["ms"]))}), flush=True)
    print(_build.card_name_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
