"""Time K3's six group ops under other constants of its G2 branch.

    python3 -m libff_tpu_torch.tune_group_ops [--against DIR]
        [NAME=V,NAME=V ...] ...

Each argument is one variant: macros of ``csrc/group_ops.cu``
(``TUNABLES``) set to other values, such as
``LFF_K3_MIN_BLOCKS_G2_PROJ=3`` (``__launch_bounds__``'s blocks an SM
for the G2 projective ops padd, pmadd, pdbl, and LFF_K3_MIN_BLOCKS_G2_JAC
for the Jacobian ones add, madd, dbl; 128 threads a block).  With no
argument the variants are 3 and 4, and 2 and 2, blocks an SM.
``--against DIR`` adds the ``group_ops.cu`` of another checkout at DIR,
such as an earlier commit whose G2 branch runs one thread an element.
On ``workload.k3_inputs`` at 2^21 elements (the size of the first
lane-halving padd on both MSM paths) it times the six ops on G1 and G2
in two passes; the package build's outputs are held against
``group_op_plain``.  The rest (builds, ptxas figures, JSON lines) is
:mod:`libff_tpu_torch.tune`'s.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import tune, workload
from .curves.device import device_curve
from .curves.group_ops import OPS, group_op, group_op_plain
from .timing import event_ms

TUNABLES = ("LFF_K3_MIN_BLOCKS_G2_PROJ", "LFF_K3_MIN_BLOCKS_G2_JAC")
DEFAULT_VARIANTS = [
    {"LFF_K3_MIN_BLOCKS_G2_PROJ": 3, "LFF_K3_MIN_BLOCKS_G2_JAC": 4},
    {"LFF_K3_MIN_BLOCKS_G2_PROJ": 2, "LFF_K3_MIN_BLOCKS_G2_JAC": 2}]
N = 1 << 21
REPS = 20


def op_args(c, cm, q_inf) -> dict:
    """op -> (coordinates, masks) of k3_inputs' arrays."""
    return {"padd": (c, ()), "add": (c, ()), "pdbl": (c[:3], ()),
            "dbl": (c[:3], ()), "pmadd": (list(cm), (q_inf,)),
            "madd": (list(cm), (q_inf,))}


def outputs(G, args) -> list:
    return [a for op in sorted(OPS) for a in group_op(G, op, *args[op])]


def cases(dev):
    dc = device_curve("alt_bn128")
    rng = np.random.default_rng(8)
    for group in ("g1", "g2"):
        G = getattr(dc, group)
        args = op_args(*workload.k3_inputs(G.F, N, rng, dev))
        want = outputs(G, args)
        plain = [a for op in sorted(OPS)
                 for a in group_op_plain(G, op, *args[op])]
        if not all(torch.equal(a, b) for a, b in zip(want, plain)):
            raise RuntimeError(f"K3 disagrees with group_op_plain on {group}")
        yield {"group": group, "n": N}, (G, args), want


def measure(case, rep):
    G, args = case
    return ({"ms": {op: event_ms(lambda: group_op(G, op, *args[op]), REPS)
                    for op in sorted(OPS)}}, outputs(G, args))


def main(argv) -> int:
    return tune.main("tune_group_ops", "group_ops", TUNABLES, argv,
                     DEFAULT_VARIANTS, cases, measure, passes=2)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
