"""Time K2 under other constants of its sort and chain kernel on the card.

    python3 -m libff_tpu_torch.tune_insert [NAME=V,NAME=V ...] ...

Each argument is one variant: macros of ``csrc/insert.cuh`` (``TUNABLES``)
set to other values, such as ``LFF_ENTRIES_G1=256,LFF_MIN_BLOCKS_G1=3``
(LFF_ENTRIES_G1 and LFF_ENTRIES_G2: the list entries a chain thread walks
on G1 and G2; LFF_MIN_BLOCKS_G1 and LFF_MIN_BLOCKS_G2:
``__launch_bounds__``'s blocks an SM; LFF_SORT_BLOCKS_PER_SM: the sort's
blocks an SM).  With no argument the variants are LFF_ENTRIES_G1 = 128,
256, 1024 beside LFF_ENTRIES_G2 = 64, 128, 512.  Each variant's
``csrc/insert.cu`` is built by its own nvcc (``_build.build_variant``),
all in parallel.  On the insert inputs of the two MSM paths (alt_bn128 G1
at 2^20 points and G2 at 2^18, c = 8, 1024 lanes) it times ``insert``
(the sort, the point records and the chain kernel) and the sort alone for
the package's build and each variant, on the path's digits and on even
digits (step t of window w in bucket (t + w) mod B, with the path's
signs, so every thread walks as many entries as every other), and holds
each variant's lists and raw buckets against the package build's on both.
It prints each build's ptxas lines and one JSON line per build and path,
then the card's name and power limit.  It needs a CUDA card and refuses
to run without one.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import sys

import torch

from . import _build, workload
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


def parse(arg: str) -> dict:
    out = {k: int(v) for k, v in (kv.split("=") for kv in arg.split(","))}
    unknown = set(out) - set(TUNABLES)
    if unknown:
        raise ValueError(f"not a macro of insert.cuh: {sorted(unknown)}")
    return out


def even_digits(d: torch.Tensor, B: int) -> torch.Tensor:
    W, T, _ = d.shape
    t = torch.arange(T, device=d.device)[None, :, None]
    w = torch.arange(W, device=d.device)[:, None, None]
    mag = (1 + (t + w) % B).to(d.dtype)
    return torch.where(d < 0, -mag, mag)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("tune_insert: needs a CUDA card", file=sys.stderr)
        return 2
    variants = [parse(a) for a in argv] or DEFAULT_VARIANTS
    _build.build()
    dev = torch.device("cuda", 0)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        paths = list(ex.map(lambda v: _build.build_variant("insert", v),
                            variants))
    builds = [("build", None, None, _build.build_dir() / "insert.so")]
    builds += [("variant", v, path, path) for v, path in zip(variants, paths)]
    dc = device_curve("alt_bn128")
    for group, log2n in PATHS:
        G = getattr(dc, group)
        scalars, points, _ = workload.msm_case(dc, group, log2n, dev)
        d, pts, B = workload.insert_inputs(G, scalars, points,
                                           default_config(1 << log2n, dev))
        de = even_digits(d, B)
        want = {k: (bucket_lists(G, x, pts[3], B), insert(G, x, pts, B))
                for k, x in (("path", d), ("even", de))}
        for kind, consts, lib, so in builds:
            with (contextlib.nullcontext() if lib is None
                  else _build.use_library("insert", lib)):
                equal = all(
                    torch.equal(a, b)
                    for k, x in (("path", d), ("even", de))
                    for got, ref in zip((bucket_lists(G, x, pts[3], B),
                                         insert(G, x, pts, B)), want[k])
                    for a, b in zip(got, ref))
                row = {"group": group, "shape": list(d.shape) + [B],
                       kind: consts, "equal_to_build": equal,
                       "ms": event_ms(lambda: insert(G, d, pts, B), REPS),
                       "even_ms": event_ms(lambda: insert(G, de, pts, B),
                                           REPS),
                       "sort_ms": event_ms(
                           lambda: bucket_lists(G, d, pts[3], B), 20)}
            if kind == "build":
                row["records_ms"] = event_ms(lambda: point_records(G, pts),
                                             20)
            row["ptxas"] = _build.ptxas_lines(so.with_suffix(".log"))
            print(json.dumps(row), flush=True)
            if not equal:
                raise RuntimeError(f"{consts} gives other lists or buckets "
                                   f"on {group}")
        del d, de, pts, want
        torch.cuda.empty_cache()
    print(_build.card_name_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
