"""Time K3's six group ops and its scan under other constants, or against
another checkout's K3.

    python3 -m libff_tpu_torch.tune_group_ops [--against DIR]
        [NAME=V,NAME=V ...] ...

Each argument is one variant: macros of ``csrc/group_ops.cu``
(``TUNABLES``) set to other values.
LFF_K3_MIN_BLOCKS_G2_PROJ and LFF_K3_MIN_BLOCKS_G2_JAC:
``__launch_bounds__``'s blocks an SM for the G2 projective ops (padd,
pmadd, pdbl) and the Jacobian ones (add, madd, dbl), 128 threads a block;
LFF_K3_PAIR_OPS_G1_N12: the 12-limb G1 ops that run the pair body
(bit 0 padd, bit 1 pmadd; 0 runs every op on the one-thread body);
LFF_K3_MIN_BLOCKS_G1_N12_PAIR and LFF_K3_MIN_BLOCKS_G1_N12: the pair
body's and the one-thread body's blocks an SM at 12 limbs (0: no
minimum); LFF_K3_QUAD_OPS_G2_N12 and LFF_K3_MIN_BLOCKS_G2_N12_QUAD: the
12-limb G2 ops that run the quad body (bits as for G1; 0 runs them on
the pair body) and its blocks an SM.  A variant rebuilds only the
sources its macros touch (``MACRO_STEMS``); the scans
(``csrc/horner.cu``, ``horner_n12.cu``) are the package build's in
every variant.  With no argument the
variants are DEFAULT_VARIANTS.  ``--against DIR`` adds the K3 sources of
another checkout at DIR (``git archive`` of an earlier commit into ``_tree/``),
built from its own sources; a checkout whose group_ops.cu has no
``group_op_at`` entry (one from before K3 read views in place) is called
through its own ``group_op`` on contiguous copies.

On ``workload.k3_inputs`` at 2^21 elements (the first lane-halving padd of
each MSM path) it times the six ops on alt_bn128 G1 and G2 and on the G1
and G2 of BLS12-381 and BLS12-377 (12 limbs); then the lane halving's 2^21 padd
on each path's bucket shape (W, 128, 1024), its two halves read in place
and as contiguous copies (the copies timed with the op); then the scan at
each path's (W, c) = (32, 8) on ``workload.scan_inputs``, in two passes.
The package build's outputs are held against ``group_op_plain`` and
``horner_scan_plain``.  The rest (builds, ptxas figures, JSON lines) is
:mod:`libff_tpu_torch.tune`'s.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from . import _build, tune, workload
from .curves.device import device_curve
from .curves.group_ops import (OPS, group_op, group_op_plain, horner_scan,
                               horner_scan_plain, k3_stem, kernel_branch)
from .msm.digits import num_signed_digits
from .timing import event_ms

STEMS = ("group_ops", "group_ops_n12", "group_ops_g2_n12",
         "group_ops_g2_nr5_n12", "horner", "horner_n12")
MACRO_STEMS = {"LFF_K3_MIN_BLOCKS_G2_PROJ": ("group_ops",),
               "LFF_K3_MIN_BLOCKS_G2_JAC": ("group_ops",),
               "LFF_K3_PAIR_OPS_G1_N12": ("group_ops_n12",),
               "LFF_K3_MIN_BLOCKS_G1_N12_PAIR": ("group_ops_n12",),
               "LFF_K3_MIN_BLOCKS_G1_N12": ("group_ops_n12",),
               "LFF_K3_QUAD_OPS_G2_N12": ("group_ops_g2_n12",
                                          "group_ops_g2_nr5_n12"),
               "LFF_K3_MIN_BLOCKS_G2_N12_QUAD": ("group_ops_g2_n12",
                                                 "group_ops_g2_nr5_n12")}
TUNABLES = tuple(MACRO_STEMS)
# every 12-limb G1 op on the one-thread body (the design before the
# pair), the G1 pair body at 3 blocks an SM; every 12-limb G2 op on the
# pair body (the design before the quad), the quad body at 3 and 5
DEFAULT_VARIANTS = [
    {"LFF_K3_PAIR_OPS_G1_N12": 0},
    {"LFF_K3_MIN_BLOCKS_G1_N12_PAIR": 3},
    {"LFF_K3_QUAD_OPS_G2_N12": 0},
    {"LFF_K3_MIN_BLOCKS_G2_N12_QUAD": 3},
    {"LFF_K3_MIN_BLOCKS_G2_N12_QUAD": 5}]
GROUPS = (("alt_bn128", "g1"), ("alt_bn128", "g2"), ("bls12_381", "g1"),
          ("bls12_377", "g1"), ("bls12_381", "g2"), ("bls12_377", "g2"))
N = 1 << 21
HALVING = (128, 1024)           # (B, L) of the first lane-halving level
REPS = 20
_OLD_ARGS = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), _build.VP,
             ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _build.U32P,
             _build.U32P, _build.U32P, ctypes.c_uint32, ctypes.c_int,
             _build.VP]


def stems_of(variant: dict) -> tuple:
    return tuple(s for s in STEMS
                 if any(s in MACRO_STEMS[k] for k in variant))


def op_args(c, cm, q_inf) -> dict:
    """op -> (coordinates, masks) of k3_inputs' arrays."""
    return {"padd": (c, ()), "add": (c, ()), "pdbl": (c[:3], ()),
            "dbl": (c[:3], ()), "pmadd": (list(cm), (q_inf,)),
            "madd": (list(cm), (q_inf,))}


def k3(G, op, coords, masks=()):
    """K3 through the loaded library: the package's wrapper, or, for a
    library with no ``group_op_at`` (an earlier checkout's), its
    ``group_op`` entry on contiguous copies."""
    k, b3, b3_mont = kernel_branch(G, "K3")
    stem = k3_stem(G.F.prime_field.n32, k, b3)
    if hasattr(_build.library(stem), "group_op_at"):
        return group_op(G, op, coords, masks)
    coords = [c.contiguous() for c in coords]
    mask = masks[0].to(torch.int32) if masks else None
    outs = [torch.empty_like(coords[0]) for _ in range(3)]
    ins = (ctypes.c_void_p * 6)(*([c.data_ptr() for c in coords]
                                  + [None] * (6 - len(coords))))
    ous = (ctypes.c_void_p * 3)(*[o.data_ptr() for o in outs])
    Fp = G.F.prime_field
    _build.launch(_build.function(stem, "group_op", _OLD_ARGS), op,
                  coords[0].device, OPS[op][0], ins,
                  _build.ptr(mask) if mask is not None else None, ous,
                  elements(G, coords[0]), Fp.n32, k, b3, b3_mont, Fp.p_c,
                  Fp.one_c, Fp.inv32, coords[0].get_device(),
                  _build.stream_ptr(coords[0]))
    return outs


def elements(G, c) -> int:
    """The elements of the coordinate array c, (*el, *batch)."""
    return c.shape[G.F.el_ndim:].numel()


def halves(buckets):
    half = buckets[0].shape[-1] // 2
    return ([a[..., :half] for a in buckets]
            + [a[..., half:2 * half] for a in buckets])


def outputs(G, args, buckets, scan, c) -> list:
    out = [a for op in sorted(OPS) for a in k3(G, op, *args[op])]
    out += k3(G, "padd", halves(buckets))
    return out + horner_scan(G, scan, c)


def cases(dev):
    rng = np.random.default_rng(8)
    for curve, group in GROUPS:
        G = getattr(device_curve(curve), group)
        args = op_args(*workload.k3_inputs(G.F, N, rng, dev))
        W = num_signed_digits(G.order, workload.scalar_bits(G), 8)
        B, L = HALVING
        buckets = [workload.rand_elements(G.F, 2 * N, rng, dev)
                   .reshape(G.F.el_shape + (2 * N // (B * L), B, L))
                   for _ in range(3)]
        scan = workload.scan_inputs(G.F, W, rng, dev)
        want = outputs(G, args, buckets, scan, 8)
        plain = [a for op in sorted(OPS)
                 for a in group_op_plain(G, op, *args[op])]
        plain += group_op_plain(G, "padd", halves(buckets))
        plain += horner_scan_plain(G, scan, 8)
        if not all(torch.equal(a, b) for a, b in zip(want, plain)):
            raise RuntimeError(f"K3 disagrees with its plain version on "
                               f"{curve} {group}")
        yield ({"curve": curve, "group": group, "n": N, "scan": [W, 8]},
               (G, args, buckets, scan), want)


def measure(case, rep):
    G, args, buckets, scan = case
    hv = halves(buckets)
    ms = {op: event_ms(lambda: k3(G, op, *args[op]), REPS)
          for op in sorted(OPS)}
    ms["halving in place"] = event_ms(lambda: k3(G, "padd", hv), REPS)
    ms["halving copied"] = event_ms(
        lambda: k3(G, "padd", [a.contiguous() for a in hv]), REPS)
    ms["scan"] = event_ms(lambda: horner_scan(G, scan, 8), REPS)
    return {"ms": ms}, outputs(G, args, buckets, scan, 8)


def main(argv) -> int:
    return tune.main("tune_group_ops", STEMS, TUNABLES, argv,
                     DEFAULT_VARIANTS, cases, measure, passes=2,
                     stems_of=stems_of)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
