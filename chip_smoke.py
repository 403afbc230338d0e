#!/usr/bin/env python3
"""Run the port's main paths on one NVIDIA card and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py

from the root of the repository, on a machine with a CUDA card and nvcc.
It builds the kernels of ``libff_tpu_torch/csrc/`` (K1e with its inverse
entry K1e inv, K2 with its sort launch and its fused merge K2m, K3 with
its scan entry, K4e with its inverse entry K4e inv, K5, K6, each of K2,
K2m and K5 over the three Montgomery products of ``MsmConfig.kmul``, the
field-mul benches K7a, K7b (with its one-chain mode K7b lone, the
latency of a lone product), K7c, K7d and the batched-affine experiment
K7e), checks each bit for bit against its plain version on the card at
the shapes its path gives it (K2, K2m, K5 and K6 on distinct points,
some at infinity; K2's sort against ``bucket_lists_plain``; K2 also on
skewed digits, at 4 windows of the path's steps and lanes; K3's scan at
the path's W = 32 totals and c = 8, with identities and repeated points;
the inverses at one element, 0, 1 and p - 1 among the inputs, and at
2^20; K2m's tail as its time less K2's on the same inputs, beside K5's,
and phase merge's line sets each K5 and K2m beside its time under the
lane tree's previous design, and the K2 phases' lines K2's sort and the
12-limb K2 beside theirs, ``BEFORE_MS``, which is not measured here),
and runs these paths through ``msm_pippenger``:

- the alt_bn128 G1 signed Pippenger MSM at 2^20 points, held against the
  exact oracle of bench.py:113-137, with the default configuration (K1e,
  K1e inv, K2 and K3's G1 branches), with merge="kernel" (K5 after K2),
  with merge=True (K2m), with engine="pallas" (K6), and with kmul="sos"
  and "sos2", each alone, with merge="kernel" and with merge=True;
- the alt_bn128 G2 MSM over Fq2 at 2^18 points, held against the oracle
  of profile/bench_g2.py:76-80, with the default configuration (K1e, K4e,
  K4e inv, K2 and K3's G2 branches), with merge="kernel", with
  merge=True, and with the same six kmul configurations;
- the G1 MSMs of BLS12-381 and BLS12-377 at 2^20 points over 12-limb Fp,
  their scalars of 255 and 253 bits, held against the same structured
  oracle with each curve's generator, with default_config(n, G) (the
  12-limb K1e, K1e inv, K2 and K3 with its scan) and with every setting
  of MSM_VARIANTS, as on alt_bn128 (the 12-limb K5, K2m, K6 and K2, K2m
  and K5 over the SOS products).  Before them the
  12-limb kernels are held bit for bit against their plain versions on
  the inputs they are timed on: K1e and K1e inv on BLS12-381's Fq at one
  element and 2^20, K3's six ops at 2^21 and its scan at the path's
  (W, c) on BLS12-381 and on BLS12-377 (its b3 = 3 instantiation), and
  K2 on both timed at the path's
  shape, the first K2_N12_WINDOWS windows of BLS12-381's timed output
  held against the plain insert on those windows (at 12 limbs the plain
  insert takes about a minute, its steps one after another; BLS12-377's
  G1 K2 is held to the oracle through its MSMs); then K5, K2m, K6 and the
  SOS branches of K2, K2m and K5 at the path's shape on both curves
  (``phase_merge``: K5 and K2m against merge_lanes_plain of K2's raw
  buckets, K6 and the SOS K2 against those buckets);
- the G2 MSMs of BLS12-381 and BLS12-377 at 2^18 points over 12-limb
  Fq2 (nr = p - 1 and p - 5), held against the same structured oracle
  with each curve's G2 generator, with default_config(n, G) (the
  12-limb K1e, K4e, K4e inv, K2 and K3 with its scan) and with every
  setting of MSM_VARIANTS.  Before them
  K4e (with K1e's Fq2 branch) and K4e inv on BLS12-381's Fq2 at one
  element and 2^18, K3's six G2 ops at 2^21 and its scan at the path's
  (W, c) on both curves, K2 on both as for G1, and the merges as for G1,
  each held bit for bit against its plain version on
  the inputs it is timed on.

Then the field-mul benches: the issue rates K7c (every body's ops a
clock per SM, mul.lo and mul.hi held to the peaks the bounds charge) and
the roofline K7a, K7b, K7d (timed at the JAX shapes, with the ratio and
production ratio of profile/roofline.py; K7b lone at 8 limbs and, on
BLS12-381's Fq, at 12 limbs over CIOS and over the scan's two-accumulator
product); each bench's timed output is
held against its plain version on the same inputs.  Their launches are
counted from 0 over these two phases.  Last the batched-affine experiment
K7e through its harness (``affine_experiment.measure``: the madd, affine
and lane-inversion bodies over T = K7E_T steps of 512 lanes, two waves of
instances, timed at T and T/2), its launches counted from 0 over the
harness; each body's timed output is held against its plain version on
its inputs (madd and affine on every instance, the lane inversion's o and
checksum on four, whose plain time the kernels line scales to all
instances as ``plain_ms`` beside ``plain_ms_measured``), and each body's
time at T must be twice its time at T/2 within 10%.  The harness's JSON line comes before the phase's.

The launch counts are set to 0 just before each path's first run and read
just after it; each default path must make one scan launch, one inverse
launch and at most 8 (G1) or 2 (G2) K1e launches; a 12-limb path
launches no 8-limb kernel but K2's sort, and a 12-limb G2 path one K2
and one K2 sort and at most G2_N12_MOST K4e and K1e launches; each
setting of MSM_VARIANTS must launch its kernel (at 12 limbs under its
12-limb name, ``n12_name``).  K2's sort rows give
``torch.sort(keys, stable=True)`` on the same keys as their library
time, the one PyTorch call that computes their permutation.  Each phase
prints one JSON line; then a
line listing the kernels with their times, bounds and launch counts, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Any failed check raises and the exit code is not 0.  Without a card it
exits 2 and prints no result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from libff_tpu_torch import _build
from libff_tpu_torch.fields.fp import to16, to32
from libff_tpu_torch.issue_rates import bound, check_imad, imad_rates, imads
from libff_tpu_torch.timing import event_ms, timed_output
from libff_tpu_torch.workload import (edge_values, k3_inputs,
                                     rand_elements, scalar_bits, scan_inputs)

LOG2N = 20
LOG2N_G2 = 18
SEED = 2024
MSM_STEADY_RUNS = 10
CHECK_CHUNK = 1 << 20           # elements a K7 plain check runs at once
K7E_CHECKED = 4                 # lane_inv instances held against the plain
# K7e's steps: a quarter of the harness's 2048, which quarters the
# phase's plain checks (sequential in the steps) to keep the smoke's time
# (the 12-limb merge phases and MSM settings took its room)
K7E_T = 512
SKEW_WINDOWS = 4                # windows of K2's skewed-digit check
INV_N = 1 << 20                 # K1e inv, K4e inv: the throughput shape
# each default path's inverse kernel and the most K1e launches it may make
INV_LAUNCHES = {"g1": ("K1e inv", 8), "g2": ("K4e inv", 2)}
# the 12-limb G1 paths, at 2^20 points like alt_bn128's G1, and G2
# paths, at 2^18 like alt_bn128's G2
CURVES12 = ("bls12_381", "bls12_377")
K2_N12_WINDOWS = 8              # windows of the 12-limb K2 checks
K2_377_WINDOWS = 2              # of BLS12-377's G2 K2 check (its G1 K2's
                                # plain insert, a minute, is not run)
# the most K4e n12 and K1e n12 launches a 12-limb G2 path makes:
# proj_to_jacobian's 3 Fq2 products and to_affine's 4; the negation of y
# in _prepare (K1e's Fq2 branch), counted on the first card run
G2_N12_MOST = {"K4e n12": 7, "K1e n12": 1}
# Times under a kernel's previous design, as this script measured them
# on an NVIDIA H100 80GB HBM3 at 700 W: K5's and K2m's under the lane
# tree's (one warp a row through a device scratch array; K2m's tail on
# each window's last block), K2's sort's under one thread a lane, the
# 12-limb G1 K2's under the 8-limb chain kernel with the bucket in
# registers, the 12-limb G1 K3's padd (2^21) under one thread an element and
# its scan (W = 32, c = 8) with each level's products through shared
# memory; the 12-limb G2 K2's under one thread a chain (Fp2Field) and its
# K3 padd under two threads an element (the pair body).  They are not
# measured here: the merge, K2 and K3 phases' lines set them beside this
# run's times as before_ms, and the kernels line leaves them out (it
# holds only what this run measured).
BEFORE_MS = {"K5 g1": 2.344, "K5 g1 sos": 2.536, "K5 g1 sos2": 2.572,
             "K5 g2": 14.15, "K5 g2 sos": 14.96, "K5 g2 sos2": 15.28,
             "K2m g1": 40.57, "K2m g1 sos": 46.88, "K2m g1 sos2": 45.87,
             "K2m g2": 145.82, "K2m g2 sos": 159.97, "K2m g2 sos2": 160.99,
             "K2 sort g1": 1.029, "K2 sort g2": 0.277, "K2 g1 n12": 59.19,
             "K3 g1 n12": 2.875, "K3 scan g1 n12": 1.073,
             "K2 g2 n12": 94.13, "K3 g2 n12": 13.41}


def inv_edges(F) -> dict[str, tuple]:
    """The one-element inputs of the inverse checks beside a random one,
    by name, as plain limb values of each coefficient: 0, 1, p - 1 and R
    mod p (the Montgomery one) in Fp; in Fq2 also 1 in the second
    coefficient."""
    p, one = F.prime_field.p, F.prime_field.mp.R % F.prime_field.p
    if F.el_ndim == 1:
        return {"0": (0,), "1": (1,), "p-1": (p - 1,), "R": (one,)}
    return {"0": (0, 0), "1": (1, 0), "u": (0, 1),
            "p-1": (p - 1, p - 1), "R": (one, 0)}
# The bounds: the card's memory rate, and each multiply kind at its peak
# a clock per SM (issue_rates.IMAD_PER_CLOCK_PER_SM: mul.lo and mad.lo at
# the Programming Guide's 64, mul.hi and mad.hi at half of it) times the
# SM count and the card's maximum SM clock (issue_rates.bound).  K7c
# confirms both peaks in every run (phase "issue rates"), and the run
# fails if either measures more than 5% away.
#
# base-field products per element: the merge's complete adds (12 products;
# an Fq2 product is three, and G2's two products by b3 add six) and K2's
# mixed add (11; 39)
FP_MULS = {"padd": {1: 12, 2: 42}, "madd": {1: 11, 2: 39}}
WORDS = {1: 8, 2: 16}           # 32-bit words of an Fp, an Fq2 element
WORDS12 = 12                    # of a 12-limb Fp element
# the Montgomery products of MsmConfig.kmul beside the default CIOS
SOS_KMULS = ("sos", "sos2")
# the MSM configurations of each path beside the default: (phase key,
# MsmConfig fields beyond c and lanes, the kernel each must launch); each
# SOS product alone, with K5 and with the fused merge
MSM_VARIANTS = {
    g: base + [(f"kmul={k}{key}", {"kmul": k, **fields}, f"{kern} {g} {k}")
               for k in SOS_KMULS
               for key, fields, kern in (
                   ("", {}, "K2"),
                   (" merge=kernel", {"merge": "kernel"}, "K5"),
                   (" merge=True", {"merge": True}, "K2m"))]
    for g, base in (
        ("g1", [("merge=kernel", {"merge": "kernel"}, "K5 g1"),
                ("merge=True", {"merge": True}, "K2m g1"),
                ("engine=pallas", {"engine": "pallas"}, "K6 g1")]),
        ("g2", [("merge=kernel", {"merge": "kernel"}, "K5 g2"),
                ("merge=True", {"merge": True}, "K2m g2")]))}




def n12_name(name: str) -> str:
    """A launch count's name at 12 limbs: the width after the group, before
    any product ("K2 g1 sos" -> "K2 g1 n12 sos", "K6 g1" -> "K6 g1
    n12")."""
    parts = name.split()
    return " ".join(parts[:2] + ["n12"] + parts[2:])


T_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also gives at_s, the seconds since
    the script started."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def host_timed(fn):
    """(fn(), host milliseconds of the synchronised call)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over all limbs, as unsigned 32-bit values."""
    err = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) & 0xFFFFFFFF) - (w.to(torch.int64) & 0xFFFFFFFF)
        err = max(err, int(d.abs().max()))
    return err


def phase_k1e(F, rng, dev) -> dict:
    """add, sub, mul and neg (sub from 0) at the main path's shapes: one
    element (to_affine's products) and 2^20 (the negation of
    every y in _prepare), timed at both."""
    from libff_tpu_torch.fields.fp import fp_op, fp_op_plain

    res = {"name": _build.width_name("K1e", F.n32), "n": 1 << 20,
           "checked_n": [1, 1 << 20], "ops": {}, "ms_at_1": {}}
    err = 0
    for n in res["checked_n"]:
        a, b = rand_elements(F, n, rng, dev), rand_elements(F, n, rng, dev)
        if n > 1:
            edges = edge_values(F)
            pairs = [(x, y) for x in edges for y in edges]
            a[:, :len(pairs)] = F.plain_from_ints([x for x, _ in pairs], dev)
            b[:, :len(pairs)] = F.plain_from_ints([y for _, y in pairs], dev)
        cases = {"add": ("add", a, b), "sub": ("sub", a, b),
                 "mul": ("mul", a, b), "neg": ("sub", torch.zeros_like(b), b)}
        for name, (op, x, y) in cases.items():
            want, plain_ms = host_timed(lambda: fp_op_plain(F, op, x, y))
            e = max_abs_err([fp_op(F, op, x, y)], [want])
            err = max(err, e)
            ms = event_ms(lambda: fp_op(F, op, x, y), 200)
            if n == res["n"]:
                res["ops"][name] = {"max_abs_err": e, "plain_ms": plain_ms,
                                    "ms": ms}
            else:
                res["ms_at_1"][name] = ms
    res["max_abs_err"] = err
    if err:
        fail(f"{res['name']} disagrees with its plain version: {res}")
    return res


def phase_k4e(F2, rng, dev) -> dict:
    """Fq2 mul and sqr (K4e), and add, sub and neg (sub from 0; K1e's Fq2
    branch, on the (2*n32, N) view) at the G2 path's shapes: one element
    (the products of to_affine) and 2^18 (the negation of
    every y in _prepare, the batch inversion of the K2 check's points),
    with every pair of edge coefficients; timed at 2^18."""
    from libff_tpu_torch.fields.tower import fq2_op, fq2_op_plain

    B = F2.B
    res = {"name": _build.width_name("K4e", B.n32), "n": 1 << LOG2N_G2,
           "checked_n": [1, 1 << LOG2N_G2], "ops": {}, "k1e_ops": {}}
    err = {"ops": 0, "k1e_ops": 0}
    for n in res["checked_n"]:
        a, b = rand_elements(F2, n, rng, dev), rand_elements(F2, n, rng, dev)
        if n > 1:
            edges = edge_values(B)
            pairs = [(x, y) for x in edges for y in edges]
            m = len(pairs)
            for i, j in ((0, 1), (1, 0)):   # a = (x, y), b = (y, x)
                a[i, :, :m] = B.plain_from_ints([q[i] for q in pairs], dev)
                b[j, :, :m] = B.plain_from_ints([q[i] for q in pairs], dev)
        cases = {"mul": ("ops", "mul", a, b), "sqr": ("ops", "sqr", a, b),
                 "add": ("k1e_ops", "add", a, b),
                 "sub": ("k1e_ops", "sub", a, b),
                 "neg": ("k1e_ops", "sub", torch.zeros_like(b), b)}
        for name, (kind, op, x, y) in cases.items():
            want, plain_ms = host_timed(lambda: fq2_op_plain(F2, op, x, y))
            e = max_abs_err([fq2_op(F2, op, x, y)], [want])
            err[kind] = max(err[kind], e)
            if n == res["n"]:
                res[kind][name] = {
                    "max_abs_err": e, "plain_ms": plain_ms,
                    "ms": event_ms(lambda: fq2_op(F2, op, x, y), 200)}
    res["max_abs_err"], res["k1e_max_abs_err"] = err["ops"], err["k1e_ops"]
    if err["ops"] or err["k1e_ops"]:
        fail(f"K4e or K1e on Fq2 disagrees with its plain version: {res}")
    return res


def phase_inv(F, rng, dev, n: int = INV_N) -> dict:
    """K1e inv (F the prime field) or K4e inv (F the Fq2 field) at the
    main path's shape, one element (to_affine's z), on each of
    inv_edges' inputs and a random element, timed there; then at INV_N
    elements with the edge values (on Fq2 every pair of them) first, timed
    there (n, INV_N by default).  Each timed output is held against its
    plain version.  The products are those of the kernel's ladder and, for
    the bounds, of the shortest sliding-window chain for p - 2
    (window_products)."""
    from libff_tpu_torch.fields.fp import (fp_inv, fp_inv_plain,
                                           ladder_products, window_products)
    from libff_tpu_torch.fields.tower import fq2_inv, fq2_inv_plain

    B = F.prime_field
    fq2 = F.el_ndim == 2
    inv, plain = (fq2_inv, fq2_inv_plain) if fq2 else (fp_inv, fp_inv_plain)
    name = _build.width_name("K4e inv" if fq2 else "K1e inv", B.n32)
    # the norm's two squarings and the last two products run side by side
    def counts(steps):
        return (steps + 4, steps + 2) if fq2 else (steps, steps)

    products, chain = counts(ladder_products(B.p - 2))
    bound_products, bound_chain = counts(window_products(B.p - 2))
    singles = {}
    for key, v in [*inv_edges(F).items(), ("random", None)]:
        x = rand_elements(F, 1, rng, dev)
        if v is not None:
            x = B.plain_from_ints(list(v), dev).T.reshape(F.el_shape + (1,))
        ms, got = timed_output(lambda: inv(F, x), 50)
        want, plain_ms = host_timed(lambda: plain(F, x))
        singles[key] = {"max_abs_err": max_abs_err([got], [want]), "ms": ms,
                        "plain_ms": plain_ms}
    a = rand_elements(F, n, rng, dev)
    ev = edge_values(B)
    if fq2:
        pairs = [(x, y) for x in ev for y in ev]
        for i in (0, 1):
            a[i, :, :len(pairs)] = B.plain_from_ints([q[i] for q in pairs],
                                                     dev)
    else:
        a[:, :len(ev)] = B.plain_from_ints(ev, dev)
    ms, got = timed_output(lambda: inv(F, a), 5)
    want, plain_ms = host_timed(lambda: plain(F, a))
    res = {"name": name, "n": n, "ms": ms, "plain_ms": plain_ms,
           "max_abs_err": max_abs_err([got], [want]),
           "products": products, "chain_products": chain,
           "bound_products": bound_products,
           "bound_chain_products": bound_chain, "at_1": singles,
           "ms_at_1": max(r["ms"] for r in singles.values()),
           "plain_ms_at_1": max(r["plain_ms"] for r in singles.values())}
    res["max_abs_err"] = max([res["max_abs_err"]] + [
        r["max_abs_err"] for r in singles.values()])
    if res["max_abs_err"]:
        fail(f"{name} disagrees with its plain version: {res}")
    return res


def phase_k3(G, group: str, rng, dev, scan_w: int, scan_c: int,
             n: int = 1 << 21) -> dict:
    """All six ops at n = 2^21 points, each path's largest padd (the
    first lane-halving level at c = 8, 1024 lanes: W*B*L/2 = 32*128*512
    for G1 at 2^20 and for G2 at 2^18), timed there; padd also at 1 point
    and padd and pdbl at 32 (the reduce's last sum tree and the old
    Horner step's size), timed there too; and padd on the two halves of
    (el, 4096, 1024) buckets read in place, as the lane halving passes
    them, held against the kernel on contiguous copies, both timed.  Then
    the scan entry at the
    path's (W, c) = (scan_w, scan_c) on scan_inputs' totals (identities
    and repeated points), its timed output held against
    horner_scan_plain.  The name is K3's launch count's (with " n12" at
    12 limbs); before_ms gives BEFORE_MS's time of the op and the scan
    under their previous design, where it has one."""
    from libff_tpu_torch.curves.group_ops import (group_op, group_op_plain,
                                                  horner_scan,
                                                  horner_scan_plain)

    c, cm, q_inf = k3_inputs(G.F, n, rng, dev)
    args = {"padd": (c, ()), "add": (c, ()), "pdbl": (c[:3], ()),
            "dbl": (c[:3], ()), "pmadd": (list(cm), (q_inf,)),
            "madd": (list(cm), (q_inf,))}
    res = {"name": _build.width_name(f"K3 {group}", G.F.prime_field.n32),
           "n": n, "ops": {}}
    err = 0
    for op, (coords, masks) in args.items():
        want, plain_ms = host_timed(
            lambda: group_op_plain(G, op, coords, masks))
        e = max_abs_err(group_op(G, op, coords, masks), want)
        del want
        err = max(err, e)
        res["ops"][op] = {
            "max_abs_err": e, "plain_ms": plain_ms,
            "ms": event_ms(lambda: group_op(G, op, coords, masks), 20)}
    for op, m in (("padd", 1), ("padd", 32), ("pdbl", 32)):
        coords = [a[..., 4096:4096 + m].contiguous() for a in args[op][0]]
        e = max_abs_err(group_op(G, op, coords),
                        group_op_plain(G, op, coords))
        err = max(err, e)
        res["ops"][f"{op}_{m}"] = {
            "max_abs_err": e,
            "ms": event_ms(lambda: group_op(G, op, coords), 200)}
    # the lane halving's first padd at the path's shape: the two halves of
    # (el, W B, 1024) buckets read in place (lanes 0-511 hold P, 512-1023
    # Q), against the kernel on contiguous copies
    el = G.F.el_shape
    buckets = [torch.cat([c[i].reshape(el + (-1, 512)),
                          c[i + 3].reshape(el + (-1, 512))], dim=-1)
               for i in range(3)]
    hv = [a[..., h * 512:(h + 1) * 512] for h in (0, 1) for a in buckets]
    got = group_op(G, "padd", hv)
    e = max_abs_err(got, group_op(G, "padd", [a.contiguous() for a in hv]))
    err = max(err, e)
    res["ops"]["padd_halves"] = {
        "max_abs_err": e, "shape": list(hv[0].shape),
        "ms": event_ms(lambda: group_op(G, "padd", hv), 20),
        "ms_copied": event_ms(
            lambda: group_op(G, "padd", [a.contiguous() for a in hv]), 20)}
    del c, cm, q_inf, args, buckets, hv, got
    tot = scan_inputs(G.F, scan_w, rng, dev)
    ms, got = timed_output(lambda: horner_scan(G, tot, scan_c), 20)
    want, plain_ms = host_timed(lambda: horner_scan_plain(G, tot, scan_c))
    e = max_abs_err(got, want)
    res["scan"] = {"W": scan_w, "c": scan_c, "max_abs_err": e, "ms": ms,
                   "plain_ms": plain_ms, "before_ms": BEFORE_MS.get(
                       _build.width_name(f"K3 scan {group}",
                                         G.F.prime_field.n32))}
    res["before_ms"] = BEFORE_MS.get(res["name"])
    res["max_abs_err"] = max(err, e)
    if res["max_abs_err"]:
        fail(f"{res['name']} disagrees with its plain version on {G.name}: "
             f"{res}")
    return res


def k2_inputs(dc, group: str, n: int, cfg, rng, dev):
    """The insert's inputs for n points of `group` under cfg, through the
    main path's _prepare and digits, with points that do not repeat: point
    t*L + l is (a + l*s + b + t*u) * gen for random a, s, b, u, the L + T
    host points summed on the card by K3.  About 1 in 64 points is flagged
    at infinity with its coordinates kept.  Returns (d, pts, B)."""
    from libff_tpu_torch import convert, workload
    from libff_tpu_torch.curves.group import AffinePoint, ProjectivePoint

    cd, G = dc.cd, getattr(dc, group)
    el, nd = G.F.el_shape, G.F.el_ndim
    L = min(cfg.lanes, n)
    T = n // L
    a, s, b, u = (int.from_bytes(rng.bytes(32), "little") % cd.r
                  for _ in range(4))

    def proj(start, step, m, shape):
        pts = workload.progression(cd, start, step, m, group)
        x, y = workload.affine_limbs(cd, pts)
        A = convert.affine_to_torch((x, y, np.zeros(m, dtype=bool)), dev, nd)
        return ProjectivePoint(*(c.reshape(el + shape)
                                 for c in G.proj_from_affine(A)))

    P = G.padd(proj(b, u, T, (T, 1)), proj(a, s, L, (1, L)))
    A = G.to_affine(G.proj_to_jacobian(P))
    x, y = A.x.reshape(el + (n,)), A.y.reshape(el + (n,))
    if bool(A.inf.any()) or torch.unique(x.reshape(-1, n).T,
                                         dim=0).shape[0] != n:
        fail("the K2 check's points are not distinct")
    inf = torch.from_numpy(rng.random(n) < 1 / 64).to(dev)
    scalars = convert.field_to_torch(workload.random_scalars(cd, n, rng), dev)
    return workload.insert_inputs(G, scalars, AffinePoint(x, y, inf), cfg)


def skewed(d, pts, B: int):
    """The insert's inputs made to strain the chain kernel, by lane l mod
    8: 0, every step in one bucket, whose chain is then T long; 1, every
    digit zero; 2, every digit +-B, the last bucket; 3, every point at
    infinity; the other lanes as given.  Returns new (d, pts)."""
    d = d.clone()
    lanes = torch.arange(d.shape[2], device=d.device)
    sign = torch.where(d < 0, -1, 1).to(d.dtype)
    one = lanes % 8 == 0
    d[:, :, one] = sign[:, :, one] * (1 + (lanes[one] // 8) % B).to(d.dtype)
    d[:, :, lanes % 8 == 1] = 0
    last = lanes % 8 == 2
    d[:, :, last] = sign[:, :, last] * B
    pinf = pts[3].clone()
    pinf[:, lanes % 8 == 3] = True
    return d, (*pts[:3], pinf)


def phase_k2(dc, group: str, n: int, cfg, rng, dev, windows=None):
    """K2 against its plain version at the path's shape, on points that do
    not repeat and some at infinity; its sort launch against
    bucket_lists_plain there, and the sort's keys through torch.sort
    (stable) for its library time; and, without `windows`, K2 on skewed
    digits (``skewed``) at SKEW_WINDOWS windows of the same (T, L).  With
    `windows`, K2 is timed at the path's shape and the first `windows`
    windows of its timed output are held against the plain version on
    those windows (a bucket depends on its own window's digits only; the
    plain insert at 12 limbs takes about a minute however few the
    windows, its T steps one after another, and the 12-limb skewed check
    runs in tests/test_torch_cuda.py at a small shape); with windows = 0
    none is.  Returns the result and, for phase_merge, the inputs and the
    plain buckets (of the checked windows; None for none)."""
    from libff_tpu_torch.msm.insert import (bucket_keys, bucket_lists,
                                            bucket_lists_plain, insert,
                                            insert_plain)

    G = getattr(dc, group)
    d, pts, B = k2_inputs(dc, group, n, cfg, rng, dev)
    checked = d.shape[0] if windows is None else windows
    dw = d[:checked].contiguous()
    want, plain_ms = (None, None) if checked == 0 else host_timed(
        lambda: insert_plain(G, dw, pts, B))
    if windows is None:
        err = max_abs_err(insert(G, d, pts, B), want)
        ms = event_ms(lambda: insert(G, d, pts, B), 3)
    else:
        ms, got = timed_output(lambda: insert(G, d, pts, B), 3)
        err = 0 if want is None else max_abs_err(
            [c[..., :checked, :, :] for c in got], want)
        del got
    madds = int(((d != 0) & ~pts[3][None]).sum())
    lists = bucket_lists(G, d, pts[3], B)
    want_lists, sort_plain_ms = host_timed(
        lambda: bucket_lists_plain(d, pts[3], B))
    keys = bucket_keys(d, pts[3], B).reshape(-1, d.shape[1])   # (W*L, T)
    sort_name = f"K2 sort g{1 if G.F.el_ndim == 1 else 2}"
    sort = {"max_abs_err": max_abs_err(lists, want_lists),
            "plain_ms": sort_plain_ms,
            "before_ms": BEFORE_MS.get(sort_name),
            "entry_bytes": lists[1].element_size(),
            "ms": event_ms(lambda: bucket_lists(G, d, pts[3], B), 20),
            "library": "torch.sort(keys (W*L, T), stable=True)",
            "library_ms": event_ms(
                lambda: torch.sort(keys, dim=-1, stable=True), 20)}
    del lists, want_lists, keys
    skew = None                                 # not run with `windows`
    if windows is None:
        ds, ps = skewed(d[:SKEW_WINDOWS], pts, B)
        skew = {"shape": list(ds.shape) + [B],
                "max_abs_err": max_abs_err(insert(G, ds, ps, B),
                                           insert_plain(G, ds, ps, B))}
        del ds, ps
    name = _build.width_name(f"K2 {group}", G.F.prime_field.n32)
    res = {"name": name, "before_ms": BEFORE_MS.get(name),
           "shape": list(d.shape) + [B], "checked_windows": checked,
           "max_abs_err": err, "points_at_infinity": int(pts[3].sum()),
           "zero_digits": int((d == 0).sum()), "madds": madds,
           "plain_ms": plain_ms, "ms": ms, "sort": sort, "skewed": skew}
    if err or sort["max_abs_err"] or (skew and skew["max_abs_err"]):
        fail(f"{res['name']} or its sort disagrees with its plain version "
             f"on {G.name}: {res}")
    return res, (d, pts, B, want)


def phase_merge(dc, group: str, k2: dict, inputs) -> dict:
    """K5, K2's fused merge (K2m), on G1 K6, and K2, K2m and K5 over each
    SOS product against their plain versions at the path's shape, on
    phase_k2's inputs and plain buckets: K5 runs on K2's raw buckets and
    K2m on the inputs, both held against merge_lanes_plain of the raw
    buckets; K2 and K6 are held against the raw buckets.  The raw buckets
    are the plain insert's where phase_k2 ran it on every window (8
    limbs), else K2's own, whose windows phase_k2 held to the plain insert
    (the first K2_N12_WINDOWS at 12 limbs; a bucket depends on its own
    window only, and the plain insert takes minutes at all 32).  Every
    product gives the same buckets, so the CIOS plain versions serve all
    of them (a plain insert takes tens of seconds at this shape).  K2m's
    plain version is insert_plain then merge_lanes_plain, and K6's is
    insert_plain, so their plain times add up phase_k2's (on its checked
    windows).  Each K2m's tail is its time less K2's over the same
    product on the same inputs, set beside K5's; "ptxas" gives the
    registers and spills of the lane tree in every merge and insert build
    of the width.  Names are the launch counts' ("K5 g1 n12 sos" at 12
    limbs)."""
    from libff_tpu_torch.msm.insert import insert, insert_v1
    from libff_tpu_torch.msm.merge import merge_lanes, merge_lanes_plain

    G = getattr(dc, group)
    n32 = G.F.prime_field.n32
    d, pts, B, raw_plain = inputs
    raw = insert(G, d, pts, B)
    checked = 0 if raw_plain is None else raw_plain[0].shape[-3]
    if checked == d.shape[0]:
        ref_raw = raw_plain
    else:
        ref_raw = raw
        if checked and max_abs_err([c[..., :checked, :, :] for c in raw],
                                   raw_plain):
            fail(f"K2 on {G.name} disagrees with its plain version")
    want, merge_ms = host_timed(lambda: merge_lanes_plain(G, ref_raw))
    fused_ms = None if k2["plain_ms"] is None else k2["plain_ms"] + merge_ms

    def name(kernel, kmul="cios"):
        return _build.kmul_name(_build.width_name(f"{kernel} {group}", n32),
                                kmul)

    runs = {name("K5"): (lambda: merge_lanes(G, raw), want, merge_ms, 20),
            name("K2m"): (lambda: insert(G, d, pts, B, merge=True), want,
                          fused_ms, 3)}
    if group == "g1":
        runs[name("K6")] = (lambda: insert_v1(G, d, pts, B), ref_raw,
                            k2["plain_ms"], 3)
    for k in SOS_KMULS:
        runs[name("K2", k)] = (
            lambda k=k: insert(G, d, pts, B, kmul=k), ref_raw,
            k2["plain_ms"], 3)
        runs[name("K2m", k)] = (
            lambda k=k: insert(G, d, pts, B, merge=True, kmul=k), want,
            fused_ms, 3)
        runs[name("K5", k)] = (lambda k=k: merge_lanes(G, raw, k), want,
                               merge_ms, 20)
    res = {"name": f"merge {group}", "curve": dc.name,
           "shape": k2["shape"], "checked_windows": checked,
           "reference": "merge_lanes_plain of the plain insert's raw buckets"
           if ref_raw is raw_plain else
           f"merge_lanes_plain of K2's raw buckets, its first {checked} "
           "windows held to insert_plain" if checked else
           "merge_lanes_plain of K2's raw buckets (K2 itself held to the "
           "oracle through its MSM)", "kernels": {},
           "ptxas": {stem: _build.tree_kernels(
                         _build.build_dir() / f"{stem}.log")
                     for kind in ("merge", "insert")
                     for stem in [_build.width_stem(_build.kmul_stem(kind, k),
                                                    n32)
                                  for k in ("cios",) + SOS_KMULS]}}
    for key, (fn, ref, plain_ms, reps) in runs.items():
        ms, got = timed_output(fn, reps)
        res["kernels"][key] = {"max_abs_err": max_abs_err(got, ref),
                               "plain_ms": plain_ms, "ms": ms,
                               "before_ms": BEFORE_MS.get(key)}
        del got
    q = res["kernels"]
    for k in ("cios",) + SOS_KMULS:
        k2_ms = k2["ms"] if k == "cios" else q[name("K2", k)]["ms"]
        k5_ms = q[name("K5", k)]["ms"]
        q[name("K2m", k)].update(
            k2_ms=k2_ms, tail_ms=q[name("K2m", k)]["ms"] - k2_ms, k5_ms=k5_ms,
            over_k2_plus_k5=q[name("K2m", k)]["ms"] / (k2_ms + k5_ms))
    if any(r["max_abs_err"] for r in res["kernels"].values()):
        fail(f"K5, K2m, K6 or a kmul branch disagrees with its plain version "
             f"on {G.name}: {res}")
    return res


def check_chunked(gots: list, plain, n: int):
    """The largest max_abs_err of a K7 bench's outputs gots, each (...,
    n), against its plain version plain(sl) on the same inputs' slice sl,
    CHECK_CHUNK elements at a time; returns (the error, the plain host
    ms)."""
    err, plain_ms = 0, 0.0
    for i in range(0, n, CHECK_CHUNK):
        sl = slice(i, min(n, i + CHECK_CHUNK))
        want, ms = host_timed(lambda: plain(sl))
        plain_ms += ms
        err = max([err] + [max_abs_err([g[..., sl]], [want]) for g in gots])
    return err, plain_ms


def phase_issue_rates(rng, dev) -> dict:
    """K7c: every body timed on issue_rates.elements words, R = 1024, at
    one element a thread (the chains also at 4 warps a SM), each timed
    launch's output held against its plain version; then the mul.lo and
    mul.hi rates held to the peaks the bounds charge."""
    from libff_tpu_torch import issue_rates as ir
    from libff_tpu_torch.roofline import random_words

    n = ir.elements(dev)
    a, b = random_words((n,), rng, dev), random_words((n,), rng, dev)
    a[0], b[0] = -1, -1                              # 0xFFFFFFFF
    res, outs = ir.rates(a, b)
    res.update(name="K7c", plain_ms={}, max_abs_err=0)
    for name in ir.BODIES:
        gots = [v for k, v in outs.items() if k.split()[0] == name]
        e, res["plain_ms"][name] = check_chunked(
            gots, lambda sl: ir.issue_body_plain(name, a[sl], b[sl]), n)
        res["max_abs_err"] = max(res["max_abs_err"], e)
    del outs
    if res["max_abs_err"]:
        fail(f"K7c disagrees with its plain version: {res}")
    res["imad_rate_over_peak"] = check_imad(res)    # raises beyond 5%
    return res


def phase_roofline(dc, rng, dev, k2_g1: dict) -> dict:
    """K7a, K7b and K7d over each product, timed at the JAX shapes (K7b
    and K7d with the edge values in the first lanes), each timed call's
    output held against its plain version on the same inputs; K1e's
    chained products; the SASS count of the products where the toolkit
    has cuobjdump; and the ratio and production ratio of
    profile/roofline.py, the latter from phase_k2's G1 insert."""
    from libff_tpu_torch import roofline as rl
    from libff_tpu_torch.fields.fp import KMULS

    res = {"name": "roofline", "kernels": {}}

    def check(key, timed, plain, n, per_elem):
        ns, got = timed()
        e, plain_ms = check_chunked([got], plain, n)
        res["kernels"][key] = {
            "max_abs_err": e, "plain_ms": plain_ms, "n": n,
            "products_per_element": per_elem, "ns_per_product": ns,
            "ms": ns * n * per_elem * 1e-6}

    a, b = rl.sol_inputs(rng, dev)
    check("K7a", lambda: rl.sol_mul_ns(a, b),
          lambda sl: rl.sol_mix_plain(a[:, sl], b[:, sl], rl.SOL_REPS),
          rl.SOL_N, rl.SOL_REPS)
    del a, b
    for F, k7 in ((dc.fq, "K7b"), (dc.fq2, "K7d")):
        B = F.prime_field
        n, reps = rl.chain_shape(F)
        a, b = rand_elements(F, n, rng, dev), rand_elements(F, n, rng, dev)
        edges = edge_values(B)
        pairs = [(x, y) for x in edges for y in edges]
        m = len(pairs)
        X = B.plain_from_ints([x for x, _ in pairs], dev)
        Y = B.plain_from_ints([y for _, y in pairs], dev)
        if F.el_ndim == 1:
            a[:, :m], b[:, :m] = X, Y
        else:                                   # a = (x, y), b = (y, x)
            a[..., :m], b[..., :m] = torch.stack([X, Y]), torch.stack([Y, X])
        for k in KMULS:
            check(f"{k7} {k}", lambda: rl.chain_mul_ns(F, k, a, b),
                  lambda sl: rl.mul_chain_plain(F, a[..., sl], b[..., sl], k,
                                                reps),
                  n, reps * rl.CHAINS[F.el_ndim])
        del a, b
    # K7b lone: one element's chain, timed at LONE_REPS and half of it
    x, y = (rand_elements(dc.fq, 1, rng, dev) for _ in range(2))
    ns, ms, outs = rl.lone_product_ns(dc.fq, x, y)
    err, plain_ms = 0, {}
    for reps, got in outs.items():
        want, plain_ms[reps] = host_timed(
            lambda: rl.lone_chain_plain(dc.fq, x, y, reps))
        err = max(err, max_abs_err([got], [want]))
    res["kernels"]["K7b lone"] = {
        "max_abs_err": err, "plain_ms": plain_ms[rl.LONE_REPS], "n": 1,
        "products_per_element": rl.LONE_REPS, "ns_per_product": ns,
        "ms": ms[rl.LONE_REPS], "ms_by_reps": ms,
        "plain_ms_by_reps": plain_ms}
    res["lone_product_ns"] = ns
    # K7b lone at 12 limbs on BLS12-381's Fq: the CIOS product and the
    # scan's two-accumulator one
    from libff_tpu_torch.curves.device import device_curve
    F12 = device_curve("bls12_381").fq
    x, y = (rand_elements(F12, 1, rng, dev) for _ in range(2))
    for product in rl.LONE_PRODUCTS[12]:
        ns, ms, outs = rl.lone_product_ns(F12, x, y, product=product)
        err, plain_ms = 0, {}
        for reps, got in outs.items():
            want, plain_ms[reps] = host_timed(
                lambda: rl.lone_chain_plain(F12, x, y, reps))
            err = max(err, max_abs_err([got], [want]))
        name = rl.lone_name(12, product)
        res["kernels"][name] = {
            "max_abs_err": err, "plain_ms": plain_ms[rl.LONE_REPS], "n": 1,
            "products_per_element": rl.LONE_REPS, "ns_per_product": ns,
            "ms": ms[rl.LONE_REPS], "ms_by_reps": ms,
            "plain_ms_by_reps": plain_ms}
        res[f"lone_product_{product}_n12_ns"] = ns
    if any(r["max_abs_err"] for r in res["kernels"].values()):
        fail(f"K7a, K7b or K7d disagrees with its plain version: {res}")
    products = {"k1e": rl.k1e_mul_ns(dc.fq, 1 << LOG2N, rng, dev)}
    products.update({k: res["kernels"][f"K7b {k}"]["ns_per_product"]
                     for k in KMULS})
    ins = k2_g1["ms"] * 1e6 / (k2_g1["madds"] * rl.MADDS_MULS)
    res.update({"field_mul_k1e_ns": products["k1e"],
                "field_mul_insert_kernel_ns": ins,
                "roofline_ns": res["kernels"]["K7a"]["ns_per_product"],
                **{f"field_mul_{k}_ns": products[k] for k in KMULS},
                **rl.ratios(res["kernels"]["K7a"]["ns_per_product"],
                            products, ins),
                "sass": rl.sass_report()})
    return res


def phase_affine(dc) -> tuple[dict, dict]:
    """K7e: the harness of affine_experiment at T = K7E_T steps (Ls = 4,
    two waves of instances), timed at T and T/2, then each timed
    output held against its plain version on its inputs: madd's and
    affine's o of every instance, lane_inv's o and chk of K7E_CHECKED
    instances spread over all (its plain version runs ~380 products an
    element, about 5 s an instance), with o = suf, the row suffix of the
    last step.  Returns (the harness's report, the phase's result); the
    launch counts of the harness's run are read by the caller."""
    from libff_tpu_torch import affine_experiment as ae

    t0 = time.perf_counter()
    _build.LAUNCHES.clear()
    rep, (a, b), outs = ae.measure(T=K7E_T)
    launches = {k: v for k, v in _build.LAUNCHES.items()
                if k.startswith("K7e")}
    inst = rep["instances"]
    _, T, _, L = a.shape
    res = {"name": "K7e", "T": T, "lanes": L, "instances": inst,
           "launches": launches, "kernels": {}}
    for body, plain in (("madd", lambda x, y: ae.madd_body_plain(dc.g1, x, y)),
                        ("affine",
                         lambda x, y: ae.affine_body_plain(dc.fq, x, y))):
        I = inst[body]
        want, plain_ms = host_timed(lambda: plain(a[:I], b[:I]))
        res["kernels"][body] = {"max_abs_err": max_abs_err([outs[body]],
                                                           [want]),
                                "plain_ms": plain_ms,
                                "plain_ms_measured": plain_ms,
                                "checked_instances": I}
    I = inst["lane_inv"]
    o, chk = outs["lane_inv"]
    idx = sorted({round(k * (I - 1) / (K7E_CHECKED - 1))
                  for k in range(K7E_CHECKED)})
    err, plain_ms, suf_err = 0, 0.0, 0
    for i in idx:
        want, ms = host_timed(lambda: ae.lane_inv_plain(dc.fq, a[i:i + 1]))
        plain_ms += ms
        err = max(err, max_abs_err([o[i:i + 1], chk[i:i + 1]], list(want)))
        d = to16(a[i, -1].reshape(8, L // ae.ROW, ae.ROW))
        suf = to32(ae.lane_scans(dc.fq.plain, d)[1]).reshape(8, L)
        suf_err = max(suf_err, max_abs_err([o[i]], [suf]))
    # plain_ms is scaled to all I instances (they are independent, and the
    # plain version's time grows with their count) so that it compares
    # with the kernel's ms; plain_ms_measured is the time on len(idx)
    res["kernels"]["lane_inv"] = {"max_abs_err": err,
                                  "plain_ms": plain_ms * I / len(idx),
                                  "plain_ms_measured": plain_ms,
                                  "checked_instances": len(idx),
                                  "o_equals_suf_max_abs_err": suf_err}
    for body, key in (("madd", "madd"), ("affine", "affine_body"),
                      ("lane_inv", "lane_inv")):
        r = res["kernels"][body]
        r.update(ms=rep["ms"][body], t_over_half_t=rep[f"{key}_t_over_half_t"])
        if not 1.8 <= r["t_over_half_t"] <= 2.2:
            fail(f"K7e {body}'s time at T is {r['t_over_half_t']:.3f} times "
                 f"its time at T/2, not 2 within 10%")
    if any(r["max_abs_err"] for r in res["kernels"].values()) or suf_err:
        fail(f"K7e disagrees with its plain version: {res}")
    res["seconds"] = time.perf_counter() - t0
    return rep, res


def phase_msm(dc, group: str, log2n: int, case, cfg) -> dict:
    """The path itself: the MSM of `group` at 2^log2n points through
    msm_pippenger and to_affine under cfg, on case = (scalars, points,
    oracle), held against the structured oracle in a first run and
    MSM_STEADY_RUNS steady runs.  The launch counts are set to 0 just
    before the first run and read just after it."""
    from libff_tpu_torch import _build, workload

    G = getattr(dc, group)
    n = 1 << log2n
    scalars, points, want = case
    runs = []
    for run in range(1 + MSM_STEADY_RUNS):
        if run == 0:
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
        got, total, times = workload.run_msm(G, scalars, points, cfg)
        if run == 0:
            launches = dict(_build.LAUNCHES)
        if got != want:
            fail(f"{group} MSM run {run} gives {got}, the oracle {want}")
        runs.append({"seconds": total, "phases": times})
    # run 0 pays the first call's set-up (lazy module loading, allocator
    # growth); the steady runs give the median and quartiles
    steady = sorted(r["seconds"] for r in runs[1:])
    q1, med, q3 = np.percentile(steady, [25, 50, 75]).tolist()
    return {"curve": dc.name, "group": group.upper(), "log2n": log2n,
            "config": cfg._asdict(), "equal_to_oracle": True,
            "first_run": runs[0], "steady_runs": len(steady),
            "seconds_median": med, "seconds_q1": q1, "seconds_q3": q3,
            "seconds_min": steady[0], "seconds_max": steady[-1],
            "phases_median": {k: float(np.median([r["phases"][k]
                                                  for r in runs[1:]]))
                              for k in runs[0]["phases"]},
            "points_per_sec": n / med, "launches": launches}


def kernel_line(k1e, k4e, inv, k3, k2, merge, msm, k7c, roof, k7e_rep, k7e,
                k7_launches, rates, n12) -> list[dict]:
    """One entry per kernel and branch: its time, its plain version's,
    its bound at the timed shape, and its launches in its path's MSM run
    (the K7 benches: in the issue-rate and roofline phases, k7_launches).
    The inverses and the scans are latency chains on the path: their rows
    also give own_latency_ms, the chain's dependent products times K7b
    lone's latency, which is that of the port's own one-thread product and
    not a bound of the card (a shorter product would lower it).
    No single PyTorch call computes a Montgomery product, an inverse or a
    group operation, so library_ms is null but on K2's sort rows, whose
    permutation torch.sort(stable=True) of the same keys computes.  The
    12-limb rows (n12, from bls_paths) come from the BLS12-381 G1 and G2
    paths."""
    src, ref = "libff_tpu_torch/csrc/", "libff_tpu/"
    out = []

    def add(name, path, source, replaces, ms, plain_ms, shape, err, bnd):
        launches = (k7_launches if path is None
                    else msm[path]["launches"]).get(name, 0)
        out.append({"name": name, "route": "cuda", "source": src + source,
                    "replaces": replaces if replaces.startswith("profile/")
                    else ref + replaces, "launches": launches,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    **bnd, "library_ms": None, "shape": shape})

    # each row's bound is its timed op's; op_bounds has every op's
    n = k1e["n"]
    ob = field_op_bounds(k1e["ops"], 1, n, rates)
    add("K1e", "g1", "fp_ops.cu", "msm/pallas_insert.py:87",
        k1e["ops"]["mul"]["ms"], k1e["ops"]["mul"]["plain_ms"], [8, n],
        max(k1e["max_abs_err"], k4e["k1e_max_abs_err"]), ob["mul"])
    # its Fq2 branch (add, sub, neg of the G2 path) is checked in phase_k4e
    out[-1].update(launches_g2=msm["g2"]["launches"].get("K1e", 0),
                   op_bounds=ob)
    n = k4e["n"]
    ob = field_op_bounds({**k4e["ops"], **k4e["k1e_ops"]}, 2, n, rates)
    add("K4e", "g2", "fp_ops.cu", "msm/pallas_insert.py:133",
        k4e["ops"]["mul"]["ms"], k4e["ops"]["mul"]["plain_ms"], [2, 8, n],
        k4e["max_abs_err"], ob["mul"])
    out[-1]["op_bounds"] = ob
    lone_ns = roof["lone_product_ns"]
    for key, g, k, replaces, computes in (
            ("fp", "g1", 1, "msm/pallas_insert.py:87", "fields/fp.py:465"),
            ("fq2", "g2", 2, "msm/pallas_insert.py:133",
             "fields/tower.py:301")):
        r = inv[key]
        n = r["n"]
        add(r["name"], g, "fp_ops.cu", replaces, r["ms"], r["plain_ms"],
            [2, 8, n] if k == 2 else [8, n], r["max_abs_err"],
            bound(2 * 4 * WORDS[k] * n, imads(r["bound_products"] * n),
                  rates))
        out[-1].update(
            computes=ref + computes, products=r["products"],
            chain_products=r["chain_products"],
            bound_products=r["bound_products"],
            bound_chain_products=r["bound_chain_products"],
            ms_at_1=r["ms_at_1"], plain_ms_at_1=r["plain_ms_at_1"],
            own_latency_ms_at_1=r["bound_chain_products"] * lone_ns * 1e-6)
    for g, k in (("g1", 1), ("g2", 2)):
        r = k3[g]
        n = r["n"]
        ob = k3_op_bounds(r, k, rates)
        add(f"K3 {g}", g, "group_ops.cu", "curves/pallas_ops.py:66",
            r["ops"]["padd"]["ms"], r["ops"]["padd"]["plain_ms"],
            [2, 8, n] if k == 2 else [8, n], r["max_abs_err"], ob["padd"])
        out[-1]["op_bounds"] = ob
        # the scan: its launch replaces the per-step K3 launches of
        # pippenger.py:419-433
        q = r["scan"]
        sc = scan_counts(q["W"], q["c"], k)
        add(f"K3 scan {g}", g, "horner.cu", "curves/pallas_ops.py:66",
            q["ms"], q["plain_ms"], [q["W"], q["c"]], q["max_abs_err"],
            bound(3 * 4 * WORDS[k] * (q["W"] + 1),
                  imads(sc["base_products"]), rates))
        out[-1].update(sc, chain_ns_per_product=q["ms"] * 1e6
                       / sc["chain_products"],
                       own_latency_ms=sc["chain_products"] * lone_ns * 1e-6)
        r = k2[g]
        W, T, L, B = r["shape"]
        # K2: digits, flags (bool bytes) and points read once, raw buckets
        # written once; K5: raw buckets read once, totals written once,
        # W*B*(L-1) adds
        k2_in = 4 * (W * T * L + 3 * WORDS[k] * T * L) + T * L
        bucket_bytes = 3 * 4 * WORDS[k] * W * B * L
        merged_bytes = 3 * 4 * WORDS[k] * W * B
        kernels = {f"K2 {g}": r, **merge[g]["kernels"]}
        # K2's sort: digits and flags (bool bytes) read once, lists
        # written once
        q = r["sort"]
        add(f"K2 sort {g}", g, "insert.cu", "msm/pallas_insert3.py:74",
            q["ms"], q["plain_ms"], [W, T, L, B], q["max_abs_err"],
            bound(4 * (W * T * L + W * L * (B + 1)) + T * L
                  + q["entry_bytes"] * W * L * T, imads(0), rates))
        out[-1].update(library_ms=q["library_ms"], library=q["library"])
        for kmul in ("cios",) + SOS_KMULS:
            k2_muls = FP_MULS["madd"][k] * r["madds"]
            k5_muls = FP_MULS["padd"][k] * W * B * (L - 1)
            path = g if kmul == "cios" else f"{g} kmul={kmul}"
            ins = _build.kmul_stem("insert", kmul) + ".cu"
            rows = [(_build.kmul_name(f"K2 {g}", kmul), path, ins,
                     "msm/pallas_insert3.py:74", k2_in + bucket_bytes,
                     k2_muls),
                    (_build.kmul_name(f"K5 {g}", kmul),
                     f"{path} merge=kernel",
                     _build.kmul_stem("merge", kmul) + ".cu",
                     "msm/pallas_insert3.py:204",
                     bucket_bytes + merged_bytes, k5_muls),
                    (_build.kmul_name(f"K2m {g}", kmul), f"{path} merge=True",
                     ins, "msm/pallas_insert3.py:172", k2_in + merged_bytes,
                     k2_muls + k5_muls)]
            if g == "g1" and kmul == "cios":
                rows.append(("K6 g1", "g1 engine=pallas", "insert.cu",
                             "msm/pallas_insert.py:35", k2_in + bucket_bytes,
                             k2_muls))
            for name, path, source, replaces, nbytes, muls in rows:
                q = kernels[name]
                add(name, path, source, replaces, q["ms"], q["plain_ms"],
                    [W, B, L] if name.startswith("K5") else [W, T, L, B],
                    q["max_abs_err"],
                    bound(nbytes, imads(muls, kmul), rates))
                # K2m's tail, measured in this run
                out[-1].update({k: q[k] for k in (
                    "k2_ms", "tail_ms", "k5_ms",
                    "over_k2_plus_k5") if q.get(k) is not None})
    # the 12-limb kernels on the BLS12-381 G1 path; K7b lone n12's
    # latencies, ns a product
    path, w = "bls12_381 g1", WORDS12
    lone12 = {p: roof[f"lone_product_{p}_n12_ns"] for p in ("cios", "eo")}
    r = n12["k1e"]
    n = r["n"]
    ob = field_op_bounds(r["ops"], 1, n, rates, n32=12)
    add("K1e n12", path, "fp_ops_n12.cu", "msm/pallas_insert.py:87",
        r["ops"]["mul"]["ms"], r["ops"]["mul"]["plain_ms"], [w, n],
        r["max_abs_err"], ob["mul"])
    out[-1]["op_bounds"] = ob
    r = n12["inv"]
    n = r["n"]
    add("K1e inv n12", path, "fp_ops_n12.cu", "msm/pallas_insert.py:87",
        r["ms"], r["plain_ms"], [w, n], r["max_abs_err"],
        bound(2 * 4 * w * n, imads(r["bound_products"] * n, n32=12), rates))
    out[-1].update(
        computes=ref + "fields/fp.py:465", products=r["products"],
        chain_products=r["chain_products"],
        bound_products=r["bound_products"],
        bound_chain_products=r["bound_chain_products"], ms_at_1=r["ms_at_1"],
        plain_ms_at_1=r["plain_ms_at_1"],
        own_latency_ms_at_1=r["bound_chain_products"] * lone12["cios"]
        * 1e-6)
    r = n12["k3"]
    ob = k3_op_bounds(r, 1, rates, n32=12)
    add("K3 g1 n12", path, "group_ops_n12.cu", "curves/pallas_ops.py:66",
        r["ops"]["padd"]["ms"], r["ops"]["padd"]["plain_ms"], [w, r["n"]],
        max(r["max_abs_err"], n12["k3 bls12_377"]["max_abs_err"]),
        ob["padd"])
    r377 = n12["k3 bls12_377"]
    out[-1].update(op_bounds=ob, ms_by_op={k: v["ms"] for k, v in
                                           r["ops"].items()},
                   bls12_377_ms_by_op={k: v["ms"] for k, v in
                                       r377["ops"].items()},
                   bls12_377_scan_ms=r377["scan"]["ms"])
    q = r["scan"]
    sc = scan_counts(q["W"], q["c"], 1)
    add("K3 scan g1 n12", path, "horner_n12.cu", "curves/pallas_ops.py:66",
        q["ms"], q["plain_ms"], [q["W"], q["c"]],
        max(q["max_abs_err"], n12["k3 bls12_377"]["scan"]["max_abs_err"]),
        bound(3 * 4 * w * (q["W"] + 1), imads(sc["base_products"], n32=12),
              rates))
    # own latency: the chain's dependent products at K7b lone n12's
    # latency of the product the scan runs (the two-accumulator one) and
    # of CIOS
    out[-1].update(sc, chain_ns_per_product=q["ms"] * 1e6
                   / sc["chain_products"],
                   own_latency_ms=sc["chain_products"] * lone12["eo"] * 1e-6,
                   own_latency_cios_ms=sc["chain_products"]
                   * lone12["cios"] * 1e-6)
    r, r377 = n12["k2"], n12["k2 bls12_377"]
    W, T, L, B = r["shape"]
    add("K2 g1 n12", path, "insert_n12.cu", "msm/pallas_insert3.py:74",
        r["ms"], r["plain_ms"], [W, T, L, B],
        max(r["max_abs_err"], r377["max_abs_err"]),
        bound(4 * (W * T * L + 3 * w * T * L) + T * L + 3 * 4 * w * W * B * L,
              imads(FP_MULS["madd"][1] * r["madds"], n32=12), rates))
    # plain_ms: insert_plain on the checked windows only
    out[-1].update(checked_windows=r["checked_windows"],
                   bls12_377_ms=r377["ms"],
                   bls12_377_checked_windows=r377["checked_windows"])
    # the 12-limb G2 kernels on the BLS12-381 G2 path (K3 and K2 also on
    # BLS12-377's, nr = p - 5)
    path, w = "bls12_381 g2", 2 * WORDS12
    r = n12["k4e g2"]
    n = r["n"]
    ob = field_op_bounds({**r["ops"], **r["k1e_ops"]}, 2, n, rates, n32=12)
    add("K4e n12", path, "fp_ops_n12.cu", "msm/pallas_insert.py:133",
        r["ops"]["mul"]["ms"], r["ops"]["mul"]["plain_ms"], [2, 12, n],
        max(r["max_abs_err"], r["k1e_max_abs_err"]), ob["mul"])
    out[-1].update(op_bounds=ob, ms_by_op={k: v["ms"] for k, v in
                                           {**r["ops"],
                                            **r["k1e_ops"]}.items()})
    r = n12["inv g2"]
    n = r["n"]
    add("K4e inv n12", path, "fp_ops_n12.cu", "msm/pallas_insert.py:133",
        r["ms"], r["plain_ms"], [2, 12, n], r["max_abs_err"],
        bound(2 * 4 * w * n, imads(r["bound_products"] * n, n32=12), rates))
    out[-1].update(
        computes=ref + "fields/tower.py:301", products=r["products"],
        chain_products=r["chain_products"],
        bound_products=r["bound_products"],
        bound_chain_products=r["bound_chain_products"], ms_at_1=r["ms_at_1"],
        plain_ms_at_1=r["plain_ms_at_1"],
        own_latency_ms_at_1=r["bound_chain_products"] * lone12["cios"]
        * 1e-6)
    r, r377 = n12["k3 g2"], n12["k3 g2 bls12_377"]
    ob = k3_op_bounds(r, 2, rates, n32=12)
    add("K3 g2 n12", path, "group_ops_g2_n12.cu", "curves/pallas_ops.py:66",
        r["ops"]["padd"]["ms"], r["ops"]["padd"]["plain_ms"],
        [2, 12, r["n"]], max(r["max_abs_err"], r377["max_abs_err"]),
        ob["padd"])
    out[-1].update(op_bounds=ob, ms_by_op={k: v["ms"] for k, v in
                                           r["ops"].items()},
                   bls12_377_ms_by_op={k: v["ms"] for k, v in
                                       r377["ops"].items()},
                   bls12_377_scan=r377["scan"])
    q = r["scan"]
    sc = scan_counts(q["W"], q["c"], 2)
    add("K3 scan g2 n12", path, "horner_n12.cu", "curves/pallas_ops.py:66",
        q["ms"], q["plain_ms"], [q["W"], q["c"]],
        max(q["max_abs_err"], r377["scan"]["max_abs_err"]),
        bound(3 * 4 * w * (q["W"] + 1), imads(sc["base_products"], n32=12),
              rates))
    out[-1].update(sc, chain_ns_per_product=q["ms"] * 1e6
                   / sc["chain_products"],
                   own_latency_ms=sc["chain_products"] * lone12["eo"] * 1e-6)
    r, r377 = n12["k2 g2"], n12["k2 g2 bls12_377"]
    W, T, L, B = r["shape"]
    add("K2 g2 n12", path, "insert_n12.cu", "msm/pallas_insert3.py:74",
        r["ms"], r["plain_ms"], [W, T, L, B],
        max(r["max_abs_err"], r377["max_abs_err"]),
        bound(4 * (W * T * L + 3 * w * T * L) + T * L + 3 * 4 * w * W * B * L,
              imads(FP_MULS["madd"][2] * r["madds"], n32=12), rates))
    out[-1].update(checked_windows=r["checked_windows"],
                   bls12_377_ms=r377["ms"],
                   bls12_377_checked_windows=r377["checked_windows"])
    n12_merge_rows(add, out, n12, rates)
    # the field-mul benches, each bound at its timed shape
    rk = roof["kernels"]
    r = rk["K7a"]
    add("K7a", None, "roofline.cu", "profile/roofline.py:108", r["ms"],
        r["plain_ms"], [8, r["n"]], r["max_abs_err"],
        bound(96 * r["n"], imads(r["n"] * r["products_per_element"]),
              rates))
    # (row, call site, element dims, 32-bit words, base products a product)
    for k7, replaces, el, words, base in (
            ("K7b", "profile/roofline.py:193", [8], 8, 1),
            ("K7d", "profile/g2_phases.py:95", [2, 8], 16, 3)):
        for kmul in ("cios",) + SOS_KMULS:
            r = rk[f"{k7} {kmul}"]
            add(f"{k7} {kmul}", None, "roofline.cu", replaces, r["ms"],
                r["plain_ms"], el + [r["n"]], r["max_abs_err"],
                bound(3 * 4 * words * r["n"], imads(
                    base * r["n"] * r["products_per_element"], kmul), rates))
    r = rk["K7b lone"]
    add("K7b lone", None, "roofline.cu", "profile/roofline.py:193", r["ms"],
        r["plain_ms"], [8, 1], r["max_abs_err"],
        bound(3 * 4 * 8, imads(r["products_per_element"]), rates))
    out[-1].update(latency_ns=r["ns_per_product"], ms_by_reps=r["ms_by_reps"])
    for product in ("cios", "eo"):
        name = f"K7b lone{'' if product == 'cios' else ' eo'} n12"
        r = rk[name]
        add(name, None, "roofline_n12.cu", "profile/roofline.py:193",
            r["ms"], r["plain_ms"], [12, 1], r["max_abs_err"],
            bound(3 * 4 * 12, imads(r["products_per_element"], n32=12),
                  rates))
        out[-1].update(latency_ns=r["ns_per_product"],
                       ms_by_reps=r["ms_by_reps"])
    # K7c's row: the carry-chain body (fp.cuh's rows) at full occupancy
    body = k7c["bodies"]["carry full"]
    n, R = k7c["elements"], k7c["op_groups"]
    add("K7c", None, "issue_rates.cu", "profile/vpu_issue.py:74",
        body["ms"], k7c["plain_ms"]["carry"], [n], k7c["max_abs_err"],
        bound(12 * n, {"lo": n * R / 2, "hi": n * R / 2}, rates))
    # K7e's rows, each bound by the harness at its timed shape
    for body, name in (("madd", "K7e madd"), ("affine", "K7e affine"),
                       ("lane_inv", "K7e inv")):
        r = k7e["kernels"][body]
        add(name, None, "affine_experiment.cu",
            "profile/affine_experiment.py:80", r["ms"], r["plain_ms"],
            [k7e["instances"][body], k7e["T"], 8, k7e["lanes"]],
            r["max_abs_err"], k7e_rep["bounds"][body])
        out[-1].update(t_over_half_t=r["t_over_half_t"],
                       plain_ms_measured=r["plain_ms_measured"],
                       plain_measured_instances=r["checked_instances"])
    return out


def n12_merge_rows(add, out: list, n12: dict, rates: dict) -> None:
    """The kernels line's rows of the 12-limb lane merges K5 and K2m, the
    v1 insert K6 and K2 over the SOS products, on the BLS12-381 paths
    (BLS12-377's times beside), through kernel_line's `add` into `out`;
    bytes and products as the 8-limb rows count them."""
    for g, k in (("g1", 1), ("g2", 2)):
        w = WORDS12 * k
        path = f"bls12_381 {g}"
        r = n12["k2" if g == "g1" else "k2 g2"]
        W, T, L, B = r["shape"]
        k2_in = 4 * (W * T * L + 3 * w * T * L) + T * L
        bucket_bytes = 3 * 4 * w * W * B * L
        merged_bytes = 3 * 4 * w * W * B
        q381 = n12[f"merge {g}"]["kernels"]
        q377 = n12[f"merge {g} bls12_377"]["kernels"]
        k2_muls = FP_MULS["madd"][k] * r["madds"]
        k5_muls = FP_MULS["padd"][k] * W * B * (L - 1)
        for kmul in ("cios",) + SOS_KMULS:
            vpath = path if kmul == "cios" else f"{path} kmul={kmul}"
            ins = _build.width_stem(_build.kmul_stem("insert", kmul), 12)
            mrg = _build.width_stem(_build.kmul_stem("merge", kmul), 12)
            rows = [("K5", f"{vpath} merge=kernel", mrg,
                     "msm/pallas_insert3.py:204", bucket_bytes + merged_bytes,
                     k5_muls),
                    ("K2m", f"{vpath} merge=True", ins,
                     "msm/pallas_insert3.py:172", k2_in + merged_bytes,
                     k2_muls + k5_muls)]
            if kmul != "cios":
                rows.insert(0, ("K2", vpath, ins, "msm/pallas_insert3.py:74",
                                k2_in + bucket_bytes, k2_muls))
            elif g == "g1":
                rows.append(("K6", f"{path} engine=pallas", ins,
                             "msm/pallas_insert.py:35", k2_in + bucket_bytes,
                             k2_muls))
            for kern, vp, stem, replaces, nbytes, muls in rows:
                name = _build.kmul_name(_build.width_name(f"{kern} {g}", 12),
                                        kmul)
                q, q7 = q381[name], q377[name]
                add(name, vp, stem + ".cu", replaces, q["ms"], q["plain_ms"],
                    [W, B, L] if kern == "K5" else [W, T, L, B],
                    max(q["max_abs_err"], q7["max_abs_err"]),
                    bound(nbytes, imads(muls, kmul, n32=12), rates))
                out[-1].update({k: q[k] for k in (
                    "k2_ms", "tail_ms", "k5_ms",
                    "over_k2_plus_k5") if q.get(k) is not None})
                out[-1].update(bls12_377_ms=q7["ms"],
                               plain_checked_windows=r["checked_windows"])


# K3's products per element by op, as formulas.cuh runs them: (products,
# squarings, products by b3).  The Jacobian add and madd also run
# dbl-2009-l (5 squarings, 2 products) for their P = Q lanes.  An Fp
# squaring is a product; an Fq2 product is three base products, a
# squaring two, and G2's b3 is a general Fq2 constant (G1's b3 = 9 is an
# addition chain).
K3_PRODUCTS = {"padd": (12, 0, 2), "pmadd": (11, 0, 2), "pdbl": (6, 2, 1),
               "add": (13, 10, 0), "madd": (9, 9, 0), "dbl": (2, 5, 0)}
# coordinates each op reads and writes, and whether it reads a mask
K3_IO = {"padd": (9, 0), "add": (9, 0), "pmadd": (8, 1), "madd": (8, 1),
         "pdbl": (6, 0), "dbl": (6, 0)}


# dependent base products of a scan doubling and a scan add, by branch:
# horner.cu runs the independent products of a level on separate lanes (G1
# two levels each; G2 three, its b3 products a level of their own)
K3_SCAN_LEVELS = {1: {"pdbl": 2, "padd": 2}, 2: {"pdbl": 3, "padd": 3}}


def k3_base_products(op: str, k: int) -> int:
    """Base-field products of one K3 op on branch k (K3_PRODUCTS)."""
    mul, sqr, b3 = K3_PRODUCTS[op]
    return mul + sqr if k == 1 else 3 * mul + 2 * sqr + 3 * b3


def scan_counts(W: int, c: int, k: int) -> dict:
    """The scan's work at (W, c) on branch k: window w's c*w doublings, the
    tree's adds whose lower slot holds a total (min(h, W) at half h; pairs
    of padding are the identity and are not added), their base products,
    and the dependent chain: c*(W-1) doublings then log2 of the tree's
    width adds, times each one's dependent products."""
    from libff_tpu_torch.curves.group_ops import tree_width

    M = tree_width(W)
    dbls = c * W * (W - 1) // 2
    adds = sum(min(M >> i, W) for i in range(1, M.bit_length()))
    lv = K3_SCAN_LEVELS[k]
    return {"doublings": dbls, "adds": adds,
            "base_products": dbls * k3_base_products("pdbl", k)
            + adds * k3_base_products("padd", k),
            "chain_products": c * (W - 1) * lv["pdbl"]
            + (M.bit_length() - 1) * lv["padd"]}


def k3_op_bounds(r: dict, k: int, rates: dict, n32: int = 8) -> dict:
    """K3's bound for each op it times at r["n"] elements of n32-limb
    coordinates."""
    n = r["n"]
    words = WORDS[k] * n32 // 8
    out = {}
    for op in r["ops"]:
        if op not in K3_PRODUCTS:
            continue
        base = k3_base_products(op, k)
        coords, mask = K3_IO[op]
        out[op] = bound(coords * 4 * words * n + 4 * mask * n,
                        imads(base * n, n32=n32), rates)
    return out


def field_op_bounds(ops: dict, k: int, n: int, rates: dict,
                    n32: int = 8) -> dict:
    """The bound of each timed elementwise op at n elements of n32 limbs
    a coefficient: two inputs and one output (sqr: one input), and its
    base products (an Fp mul one; an Fq2 mul three, a sqr two; add, sub
    and neg none)."""
    products = {"mul": 1 if k == 1 else 3, "sqr": 2}
    words = WORDS[k] * n32 // 8
    return {op: bound((2 if op == "sqr" else 3) * 4 * words * n,
                      imads(products.get(op, 0) * n, n32=n32), rates)
            for op in ops}


def bls_paths(rng, dev) -> dict:
    """The 12-limb G1 paths: K1e, K1e inv, K3 (with its scan) on
    BLS12-381 and K3 with its scan on BLS12-377, held against their plain
    versions; K2 and the merge kernels (phase_merge) on both; then each
    curve's G1 MSM at 2^20 points under default_config(n, G), with the
    launch checks of the alt_bn128 paths and no 8-limb kernel launched,
    and under every setting of MSM_VARIANTS (n12_variants).  Then the
    12-limb G2 paths (``bls_g2_paths``).  Prints each phase's line;
    returns the results by key."""
    from libff_tpu_torch import workload
    from libff_tpu_torch.curves.device import device_curve
    from libff_tpu_torch.msm.digits import num_signed_digits
    from libff_tpu_torch.msm.pippenger import default_config

    n = 1 << LOG2N
    dc = device_curve("bls12_381")
    G = dc.g1
    cfg = default_config(n, G, dev)
    out = {"k1e": phase_k1e(dc.fq, rng, dev)}
    emit({"phase": "K1e bls12_381", **out["k1e"]})
    out["inv"] = phase_inv(dc.fq, rng, dev)
    emit({"phase": "K1e inv bls12_381", **out["inv"]})
    W = num_signed_digits(G.order, scalar_bits(G), cfg.c)
    out["k3"] = phase_k3(G, "g1", rng, dev, W, cfg.c)
    emit({"phase": "K3 bls12_381 g1", **out["k3"]})
    out["k3 bls12_377"] = phase_k3(device_curve("bls12_377").g1, "g1", rng,
                                   dev, W, cfg.c)
    emit({"phase": "K3 bls12_377 g1", **out["k3 bls12_377"]})
    out["k2"], inputs = phase_k2(dc, "g1", n, cfg, rng, dev, K2_N12_WINDOWS)
    emit({"phase": "K2 bls12_381 g1", **out["k2"]})
    out["merge g1"] = phase_merge(dc, "g1", out["k2"], inputs)
    del inputs
    emit({"phase": "merge bls12_381 g1", **out["merge g1"]})
    dc377 = device_curve("bls12_377")
    out["k2 bls12_377"], inputs = phase_k2(
        dc377, "g1", n, default_config(n, dc377.g1, dev), rng, dev, 0)
    emit({"phase": "K2 bls12_377 g1", **out["k2 bls12_377"]})
    out["merge g1 bls12_377"] = phase_merge(dc377, "g1",
                                            out["k2 bls12_377"], inputs)
    del inputs
    emit({"phase": "merge bls12_377 g1", **out["merge g1 bls12_377"]})
    for curve in CURVES12:
        dcc = device_curve(curve)
        cfg = default_config(n, dcc.g1, dev)
        case = workload.msm_case(dcc, "g1", LOG2N, dev, SEED)
        r = phase_msm(dcc, "g1", LOG2N, case, cfg)
        emit({"phase": f"msm {curve} g1", **r})
        got = r["launches"]
        if got.get("K3 scan g1 n12", 0) != 1 or got.get("K2 g1 n12", 0) != 1:
            fail(f"the {curve} path made {got.get('K3 scan g1 n12', 0)} K3 "
                 f"scan and {got.get('K2 g1 n12', 0)} K2 launches, not 1")
        if got.get("K1e inv n12", 0) != 1 or got.get("K1e n12", 0) > 8:
            fail(f"the {curve} path made {got.get('K1e inv n12', 0)} K1e inv "
                 f"and {got.get('K1e n12', 0)} K1e launches, not 1 and at "
                 "most 8")
        other = [k for k in got if not k.endswith(" n12") and k != "K2 sort g1"]
        if other or got.get("K3 g1 n12", 0) < 1:
            fail(f"the {curve} path launched {got}")
        out[f"msm {curve} g1"] = r
        out.update(n12_variants(dcc, "g1", LOG2N, case, cfg))
        del case
    out.update(bls_g2_paths(rng, dev))
    return out


def n12_variants(dc, group: str, log2n: int, case, cfg) -> dict:
    """Every MsmConfig setting of MSM_VARIANTS on a 12-limb path beside
    its default cfg, at the path's size, each held against the oracle:
    each must launch its kernel under its 12-limb name (n12_name) and no
    8-limb kernel but K2's sort.  Prints each phase's line; returns the
    results by key, "msm <curve> <group> <setting>"."""
    out = {}
    for key, fields, kernel in MSM_VARIANTS[group]:
        r = phase_msm(dc, group, log2n, case, cfg._replace(**fields))
        got = r["launches"]
        if got.get(n12_name(kernel), 0) < 1:
            fail(f"{n12_name(kernel)} was not launched on the {dc.name} "
                 f"{group} {key} path: {got}")
        if [k for k in got if " n12" not in k and not k.startswith("K2 sort")]:
            fail(f"the {dc.name} {group} {key} path launched {got}")
        out[f"msm {dc.name} {group} {key}"] = r
        emit({"phase": f"msm {dc.name} {group} {key}", **r})
    return out


def bls_g2_paths(rng, dev) -> dict:
    """The 12-limb G2 paths over Fq2 (nr = p - 1 on BLS12-381, p - 5 on
    BLS12-377): K4e (with K1e's Fq2 branch) and K4e inv on BLS12-381's
    Fq2 at the path's 2^18 elements, K3's six ops at 2^21 and its scan at
    the path's (W, c) on both curves, and K2 on both timed at the path's
    shape, its first K2_N12_WINDOWS (BLS12-381) and K2_377_WINDOWS
    (BLS12-377) windows held to the plain insert, with the merge kernels
    (phase_merge); then each curve's G2 MSM at 2^18 points under
    default_config(n, G) against its oracle: one K2, K2 sort, scan and
    K4e inv launch, at least one K3, at most G2_N12_MOST K4e and K1e
    launches and no 8-limb kernel; and under every setting of
    MSM_VARIANTS (n12_variants)."""
    from libff_tpu_torch import workload
    from libff_tpu_torch.curves.device import device_curve
    from libff_tpu_torch.msm.digits import num_signed_digits
    from libff_tpu_torch.msm.pippenger import default_config

    n = 1 << LOG2N_G2
    dc = device_curve("bls12_381")
    G = dc.g2
    cfg = default_config(n, G, dev)
    out = {"k4e g2": phase_k4e(dc.fq2, rng, dev)}
    emit({"phase": "K4e bls12_381", **out["k4e g2"]})
    out["inv g2"] = phase_inv(dc.fq2, rng, dev, n)
    emit({"phase": "K4e inv bls12_381", **out["inv g2"]})
    W = num_signed_digits(G.order, scalar_bits(G), cfg.c)
    out["k3 g2"] = phase_k3(G, "g2", rng, dev, W, cfg.c)
    emit({"phase": "K3 bls12_381 g2", **out["k3 g2"]})
    out["k3 g2 bls12_377"] = phase_k3(device_curve("bls12_377").g2, "g2",
                                      rng, dev, W, cfg.c)
    emit({"phase": "K3 bls12_377 g2", **out["k3 g2 bls12_377"]})
    out["k2 g2"], inputs = phase_k2(dc, "g2", n, cfg, rng, dev,
                                    K2_N12_WINDOWS)
    emit({"phase": "K2 bls12_381 g2", **out["k2 g2"]})
    out["merge g2"] = phase_merge(dc, "g2", out["k2 g2"], inputs)
    del inputs
    emit({"phase": "merge bls12_381 g2", **out["merge g2"]})
    dc377 = device_curve("bls12_377")
    out["k2 g2 bls12_377"], inputs = phase_k2(
        dc377, "g2", n, default_config(n, dc377.g2, dev), rng, dev,
        K2_377_WINDOWS)
    emit({"phase": "K2 bls12_377 g2", **out["k2 g2 bls12_377"]})
    out["merge g2 bls12_377"] = phase_merge(dc377, "g2",
                                            out["k2 g2 bls12_377"], inputs)
    del inputs
    emit({"phase": "merge bls12_377 g2", **out["merge g2 bls12_377"]})
    for curve in CURVES12:
        dcc = device_curve(curve)
        cfg = default_config(n, dcc.g2, dev)
        case = workload.msm_case(dcc, "g2", LOG2N_G2, dev, SEED)
        r = phase_msm(dcc, "g2", LOG2N_G2, case, cfg)
        emit({"phase": f"msm {curve} g2", **r})
        got = r["launches"]
        once = ("K2 g2 n12", "K2 sort g2", "K3 scan g2 n12", "K4e inv n12")
        if any(got.get(k, 0) != 1 for k in once):
            fail(f"the {curve} G2 path did not launch each of {once} once: "
                 f"{got}")
        if any(got.get(k, 0) > most for k, most in G2_N12_MOST.items()):
            fail(f"the {curve} G2 path made more K4e or K1e launches than "
                 f"{G2_N12_MOST}: {got}")
        other = [k for k in got if not k.endswith(" n12") and k != "K2 sort g2"]
        if other or got.get("K3 g2 n12", 0) < 1:
            fail(f"the {curve} G2 path launched {got}")
        out[f"msm {curve} g2"] = r
        out.update(n12_variants(dcc, "g2", LOG2N_G2, case, cfg))
        del case
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from libff_tpu_torch import workload
    from libff_tpu_torch.curves.device import device_curve
    from libff_tpu_torch.msm.digits import num_signed_digits
    from libff_tpu_torch.msm.pippenger import default_config

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "env", **_build.env_report(), "device": name,
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    per_source = _build.build()
    ptxas = {p.stem: _build.ptxas_lines(p)
             for p in sorted(_build.build_dir().glob("*.log"))}
    # the redesigned K2 and K3 kernels' registers and spills (the K3 G1
    # kernels' names carry the field context, FpField<12, b3>, and the
    # op, 0-5 as in group_ops.cu)
    # and the 12-limb G2 kernels' (Fp2Pair: K2's chains on pairs, K3 on
    # pairs and its split kernel on quads; the scan's G2 kernel is
    # horner_g2_kernel)
    redesigned = {name: [k for k in _build.ptxas_kernels(_build.build_dir()
                                                         / log)
                         if all(s in k["function"] for s in kernel)]
                  for name, log, kernel in (
                      ("K2 sort", "insert.log", ("bucket_lists_kernel",)),
                      ("K2 g1 n12", "insert_n12.log",
                       ("chain_kernel", "FpField")),
                      ("K3 g1 n12", "group_ops_n12.log",
                       ("group_op", "FpField")),
                      ("K3 scan g1 n12", "horner_n12.log",
                       ("horner_kernel",)),
                      ("K2 g2 n12", "insert_n12.log",
                       ("chain_kernel", "Fp2Pair")),
                      ("K3 g2 n12", "group_ops_g2_n12.log",
                       ("group_op",)),
                      ("K3 g2 n12 nr5", "group_ops_g2_nr5_n12.log",
                       ("group_op",)),
                      ("K3 scan g2 n12", "horner_n12.log",
                       ("horner_g2_kernel",)))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": per_source, "redesigned_ptxas": redesigned,
          "ptxas": ptxas})

    dc = device_curve("alt_bn128")
    rng = np.random.default_rng(SEED)
    k3, k2, merge, msm = {}, {}, {}, {}

    def group_path(group: str, log2n: int):
        """K3, K2, the merge kernels and every MSM configuration of one
        group's path."""
        n = 1 << log2n
        G = getattr(dc, group)
        cfg = default_config(n, G, dev)
        # the scan's (W, c) on the path: W window totals, c doublings a step
        W = num_signed_digits(G.order, scalar_bits(G), cfg.c)
        k3[group] = phase_k3(G, group, rng, dev, W, cfg.c)
        emit({"phase": f"K3 {group}", **k3[group]})
        k2[group], inputs = phase_k2(dc, group, n, cfg, rng, dev)
        emit({"phase": f"K2 {group}", **k2[group]})
        merge[group] = phase_merge(dc, group, k2[group], inputs)
        del inputs
        emit({"phase": f"merge {group}", **merge[group]})
        case = workload.msm_case(dc, group, log2n, dev, SEED)
        msm[group] = phase_msm(dc, group, log2n, case, cfg)
        emit({"phase": f"msm {group}", **msm[group]})
        if msm[group]["launches"].get(f"K3 scan {group}", 0) != 1:
            fail(f"Horner was not one K3 scan launch on the {group} path")
        # to_affine's inverse is one launch; K1e is left the negation of y
        # in _prepare and on G1 proj_to_jacobian's 3 and to_affine's 4
        name, most = INV_LAUNCHES[group]
        got = msm[group]["launches"]
        if got.get(name, 0) != 1 or got.get("K1e", 0) > most:
            fail(f"the {group} path made {got.get(name, 0)} {name} and "
                 f"{got.get('K1e', 0)} K1e launches, not 1 and at most "
                 f"{most}")
        for key, fields, kernel in MSM_VARIANTS[group]:
            r = phase_msm(dc, group, log2n, case, cfg._replace(**fields))
            if r["launches"].get(kernel, 0) < 1:
                fail(f"{kernel} was not launched on the {group} {key} path")
            msm[f"{group} {key}"] = r
            emit({"phase": f"msm {group} {key}", **r})

    # the G1 path: 2^20 points
    k1e = phase_k1e(dc.fq, rng, dev)
    emit({"phase": "K1e", **k1e})
    inv = {"fp": phase_inv(dc.fq, rng, dev)}
    emit({"phase": "K1e inv", **inv["fp"]})
    group_path("g1", LOG2N)

    # the G2 path: 2^18 points over Fq2
    k4e = phase_k4e(dc.fq2, rng, dev)
    emit({"phase": "K4e", **k4e})
    inv["fq2"] = phase_inv(dc.fq2, rng, dev)
    emit({"phase": "K4e inv", **inv["fq2"]})
    group_path("g2", LOG2N_G2)

    # the 12-limb G1 paths: BLS12-381 and BLS12-377 at 2^20 points
    n12 = bls_paths(rng, dev)
    msm.update({k[4:]: v for k, v in n12.items() if k.startswith("msm ")})

    # the field-mul benches; no MSM runs them, so their launches are
    # counted over these two phases
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    k7c = phase_issue_rates(rng, dev)
    emit({"phase": "issue rates", **k7c})
    roof = phase_roofline(dc, rng, dev, k2["g1"])
    emit({"phase": "roofline", **roof})
    k7_launches = {k: v for k, v in _build.LAUNCHES.items()
                   if k.startswith("K7")}
    # the batched-affine experiment, its launches counted over its harness
    k7e_rep, k7e = phase_affine(dc)
    emit(k7e_rep)
    emit({"phase": "affine experiment", **k7e})
    k7_launches.update(k7e["launches"])

    kernels = kernel_line(k1e, k4e, inv, k3, k2, merge, msm, k7c, roof,
                          k7e_rep, k7e, k7_launches, imad_rates(dev), n12)
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on its path")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(_build.card_name_power(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
