"""Time K3's six group ops under other constants of its G2 branch.

    python3 -m libff_tpu_torch.tune_group_ops [--against DIR]
        [NAME=V,NAME=V ...] ...

Each argument is one variant: macros of ``csrc/group_ops.cu``
(``TUNABLES``) set to other values, such as
``LFF_K3_MIN_BLOCKS_G2_PROJ=3`` (``__launch_bounds__``'s blocks an SM
for the G2 projective ops padd, pmadd, pdbl, and LFF_K3_MIN_BLOCKS_G2_JAC
for the Jacobian ones add, madd, dbl; 128 threads a block).  With no
argument the variants are 3 and 4, and 2 and 2, blocks an SM.
``--against DIR`` adds the ``group_ops.cu`` of another checkout at DIR
(an earlier commit unpacked with ``git archive``, such as one whose G2
branch runs one thread an element), built from its own sources, as one
more variant.  Each variant is built by its own nvcc
(``_build.build_variant``), all in parallel.  On
``workload.k3_inputs`` at 2^21 elements (the size of the first
lane-halving padd on both MSM paths) it times the six ops on G1 and G2
for the package's build and each variant, in two passes (build,
variants, then the same again); it holds the package build's outputs
against ``group_op_plain`` and each variant's against the package
build's.  It prints each build's ptxas lines and one JSON line per
build, group and pass, then the card's name and power limit.  It needs a
CUDA card and refuses to run without one.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import pathlib
import sys

import numpy as np
import torch

from . import _build, workload
from .curves.device import device_curve
from .curves.group_ops import OPS, group_op, group_op_plain
from .timing import event_ms

TUNABLES = ("LFF_K3_MIN_BLOCKS_G2_PROJ", "LFF_K3_MIN_BLOCKS_G2_JAC")
DEFAULT_VARIANTS = [
    {"LFF_K3_MIN_BLOCKS_G2_PROJ": 3, "LFF_K3_MIN_BLOCKS_G2_JAC": 4},
    {"LFF_K3_MIN_BLOCKS_G2_PROJ": 2, "LFF_K3_MIN_BLOCKS_G2_JAC": 2}]
N = 1 << 21
REPS = 20
PASSES = 2


def parse(arg: str) -> dict:
    out = {k: int(v) for k, v in (kv.split("=") for kv in arg.split(","))}
    unknown = set(out) - set(TUNABLES)
    if unknown:
        raise ValueError(f"not a macro of group_ops.cu: {sorted(unknown)}")
    return out


def op_args(c, cm, q_inf) -> dict:
    """op -> (coordinates, masks) of k3_inputs' arrays."""
    return {"padd": (c, ()), "add": (c, ()), "pdbl": (c[:3], ()),
            "dbl": (c[:3], ()), "pmadd": (list(cm), (q_inf,)),
            "madd": (list(cm), (q_inf,))}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("tune_group_ops: needs a CUDA card", file=sys.stderr)
        return 2
    against = None
    if argv[:1] == ["--against"]:
        against, argv = pathlib.Path(argv[1]), argv[2:]
    variants = [parse(a) for a in argv] or DEFAULT_VARIANTS
    _build.build()
    dev = torch.device("cuda", 0)
    jobs = [(v, None) for v in variants]
    if against is not None:
        jobs.append(({}, against / "libff_tpu_torch/csrc/group_ops.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        paths = list(ex.map(
            lambda j: _build.build_variant("group_ops", *j), jobs))
    builds = [("build", None, None, _build.build_dir() / "group_ops.so")]
    builds += [("variant", v, path, path)
               for (v, _), path in zip(jobs[:len(variants)], paths)]
    if against is not None:
        builds.append(("against", str(against), paths[-1], paths[-1]))
    dc = device_curve("alt_bn128")
    rng = np.random.default_rng(8)
    cases = {}
    for group in ("g1", "g2"):
        G = getattr(dc, group)
        args = op_args(*workload.k3_inputs(G.F, N, rng, dev))
        want = {op: group_op(G, op, *args[op]) for op in OPS}
        if not all(torch.equal(a, b) for op in OPS
                   for a, b in zip(want[op],
                                   group_op_plain(G, op, *args[op]))):
            raise RuntimeError(f"K3 disagrees with group_op_plain on {group}")
        cases[group] = (G, args, want)
    for rep in range(PASSES):
        for kind, consts, lib, so in builds:
            with (contextlib.nullcontext() if lib is None
                  else _build.use_library("group_ops", lib)):
                for group, (G, args, want) in cases.items():
                    equal = all(torch.equal(a, b) for op in OPS
                                for a, b in zip(group_op(G, op, *args[op]),
                                                want[op]))
                    row = {"group": group, "n": N, "pass": rep, kind: consts,
                           "equal_to_build": equal, "ms": {
                               op: event_ms(
                                   lambda: group_op(G, op, *args[op]), REPS)
                               for op in sorted(OPS)}}
                    if rep == 0 and group == "g1":
                        row["ptxas"] = _build.ptxas_lines(
                            so.with_suffix(".log"))
                    print(json.dumps(row), flush=True)
                    if not equal:
                        raise RuntimeError(f"{kind} {consts} gives other "
                                           f"{group} coordinates")
    print(_build.card_name_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
