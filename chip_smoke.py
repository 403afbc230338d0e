#!/usr/bin/env python3
"""Run the port's main path on one NVIDIA card and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py

from the root of the repository, on a machine with a CUDA card and nvcc.
It builds the kernels of ``libff_tpu_torch/csrc/`` (K1e, K2, K3), checks
each bit for bit against its plain version on the card at the shapes the
main path gives it (K2 on distinct points, some at infinity), then runs the
alt_bn128 G1 signed Pippenger MSM at 2^20 points through
``msm_pippenger`` and holds the affine result against the exact oracle of
bench.py:113-137.  Each phase prints one JSON line; then a line listing
the kernels with their launch counts from the MSM run, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  Any failed
check raises and the exit code is not 0.  Without a card it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

LOG2N = 20
SEED = 2024
MSM_STEADY_RUNS = 10


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn over reps calls (warmed)."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


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


def rand_elements(F, n: int, rng, dev) -> torch.Tensor:
    """n canonical field elements (n32, n): random limbs under p's top limb."""
    limbs = rng.integers(0, 1 << 32, size=(F.n32, n), dtype=np.uint64)
    limbs[-1] = rng.integers(0, F.p_limbs[-1], size=n, dtype=np.uint64)
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)


def phase_k1e(F, rng, dev) -> dict:
    """add, sub, mul and neg (sub from 0) at the main path's shapes: one
    element (the Fermat inverse of to_affine) and 2^20 (the negation of
    every y in _prepare), timed at 2^20."""
    from libff_tpu_torch.fields.fp import fp_op, fp_op_plain

    res = {"name": "K1e", "n": 1 << 20, "checked_n": [1, 1 << 20], "ops": {}}
    err = 0
    for n in res["checked_n"]:
        a, b = rand_elements(F, n, rng, dev), rand_elements(F, n, rng, dev)
        if n > 1:
            p, R = F.p, F.mp.R
            edges = sorted({0, 1, 2, p - 1, p - 2, (p - 1) // 2, R % p,
                            p - R % p, (1 << 32) - 1, (1 << 224) % p,
                            p - (1 << 128)})
            pairs = [(x, y) for x in edges for y in edges]
            a[:, :len(pairs)] = F.plain_from_ints([x for x, _ in pairs], dev)
            b[:, :len(pairs)] = F.plain_from_ints([y for _, y in pairs], dev)
        cases = {"add": ("add", a, b), "sub": ("sub", a, b),
                 "mul": ("mul", a, b), "neg": ("sub", torch.zeros_like(b), b)}
        for name, (op, x, y) in cases.items():
            want, plain_ms = host_timed(lambda: fp_op_plain(F, op, x, y))
            e = max_abs_err([fp_op(F, op, x, y)], [want])
            err = max(err, e)
            if n == res["n"]:
                res["ops"][name] = {
                    "max_abs_err": e, "plain_ms": plain_ms,
                    "ms": event_ms(lambda: fp_op(F, op, x, y), 200)}
    res["max_abs_err"] = err
    if err:
        fail(f"K1e disagrees with its plain version: {res}")
    return res


def k3_inputs(F, n: int, rng, dev):
    """Six coordinate arrays and a mask, random elements with edge lanes:
    P = 0, Q = 0, Q = P, Q = -P and Q = P in another Jacobian scaling."""
    c = [rand_elements(F, n, rng, dev) for _ in range(6)]
    x1, y1, z1, x2, y2, z2 = c
    w = rand_elements(F, 64, rng, dev)
    z1[:, 0:64] = 0                                   # P = 0
    z2[:, 64:128] = 0                                 # Q = 0
    for k in range(3):                                # Q = P
        c[3 + k][:, 128:192] = c[k][:, 128:192]
    x2[:, 192:256], z2[:, 192:256] = x1[:, 192:256], z1[:, 192:256]
    y2[:, 192:256] = F.neg(y1[:, 192:256])            # Q = -P
    s = slice(256, 320)                               # Q = P scaled by w
    w2 = F.sqr(w)
    x2[:, s] = F.mul(x1[:, s], w2)
    y2[:, s] = F.mul(y1[:, s], F.mul(w2, w))
    z2[:, s] = F.mul(z1[:, s], w)
    q_inf = torch.zeros(n, dtype=torch.bool, device=dev)
    q_inf[64:128] = True
    q_inf[1024:1100] = True
    # mixed adds: P = (x w^2, y w^3, w) against the affine Q = (x, y) on
    # [256, 320) and Q = (x, -y) on [320, 384)
    ax, ay = x2.clone(), y2.clone()
    x1m, y1m, z1m = x1.clone(), y1.clone(), z1.clone()
    for sl, sign in ((s, 1), (slice(320, 384), -1)):
        ax[:, sl] = x1[:, sl]
        ay[:, sl] = y1[:, sl] if sign > 0 else F.neg(y1[:, sl])
        x1m[:, sl] = F.mul(x1[:, sl], w2)
        y1m[:, sl] = F.mul(y1[:, sl], F.mul(w2, w))
        z1m[:, sl] = w
    return c, (x1m, y1m, z1m, ax, ay), q_inf


def phase_k3(G, rng, dev) -> dict:
    """All six ops at 2^21 points, the main path's largest padd (the first
    lane-halving level at c = 8, 1024 lanes), timed there; padd also at 1
    point and padd and pdbl at 32 (the Horner scan's and the last sum
    tree's sizes)."""
    from libff_tpu_torch.curves.group_ops import group_op, group_op_plain

    n = 1 << 21
    c, cm, q_inf = k3_inputs(G.F, n, rng, dev)
    args = {"padd": (c, ()), "add": (c, ()), "pdbl": (c[:3], ()),
            "dbl": (c[:3], ()), "pmadd": (list(cm), (q_inf,)),
            "madd": (list(cm), (q_inf,))}
    res = {"name": "K3", "n": n, "ops": {}}
    err = 0
    for op, (coords, masks) in args.items():
        want, plain_ms = host_timed(
            lambda: group_op_plain(G, op, coords, masks))
        e = max_abs_err(group_op(G, op, coords, masks), want)
        err = max(err, e)
        res["ops"][op] = {
            "max_abs_err": e, "plain_ms": plain_ms,
            "ms": event_ms(lambda: group_op(G, op, coords, masks), 20)}
    for op, m in (("padd", 1), ("padd", 32), ("pdbl", 32)):
        coords = [a[:, 4096:4096 + m].contiguous() for a in args[op][0]]
        e = max_abs_err(group_op(G, op, coords),
                        group_op_plain(G, op, coords))
        err = max(err, e)
        res["ops"][f"{op}_{m}"] = {"max_abs_err": e}
    res["max_abs_err"] = err
    if err:
        fail(f"K3 disagrees with its plain version: {res}")
    return res


def prepared(dc, scalars, points, cfg):
    """The main path's insert inputs: (d, pts, B)."""
    from libff_tpu_torch.msm import digits as dig
    from libff_tpu_torch.msm.pippenger import _prepare

    G = dc.g1
    W = dig.num_signed_digits(G.order, 254, cfg.c)
    s, pts, T, L = _prepare(G, scalars, points, cfg)
    return dig.signed_digits(s, cfg.c, W).reshape(W, T, L), pts, 1 << (cfg.c - 1)


def k2_inputs(dc, n: int, cfg, rng, dev):
    """The insert's inputs for n points under cfg, through the main path's
    _prepare and digits, with points that do not repeat: point t*L + l is
    (a + l*s + b + t*u) * gen for random a, s, b, u, the L + T host points
    summed on the card by K3.  About 1 in 64 points is flagged at infinity
    with its coordinates kept.  Returns (d, pts, B)."""
    from libff_tpu_torch import convert, workload
    from libff_tpu_torch.curves.group import AffinePoint, ProjectivePoint

    cd, G = dc.cd, dc.g1
    L = min(cfg.lanes, n)
    T = n // L
    a, s, b, u = (int.from_bytes(rng.bytes(32), "little") % cd.r
                  for _ in range(4))

    def proj(start, step, m, shape):
        x, y = workload.affine_limbs(cd, workload.progression(cd, start, step, m))
        A = convert.affine_to_torch((x, y, np.zeros(m, dtype=bool)), dev)
        return ProjectivePoint(*(c.reshape(shape)
                                 for c in G.proj_from_affine(A)))

    n32 = G.F.n32
    P = G.padd(proj(b, u, T, (n32, T, 1)), proj(a, s, L, (n32, 1, L)))
    A = G.to_affine(G.proj_to_jacobian(P))
    x, y = A.x.reshape(n32, n), A.y.reshape(n32, n)
    if bool(A.inf.any()) or torch.unique(x.T, dim=0).shape[0] != n:
        fail("the K2 check's points are not distinct")
    inf = torch.from_numpy(rng.random(n) < 1 / 64).to(dev)
    scalars = convert.field_to_torch(workload.random_scalars(cd, n, rng), dev)
    return prepared(dc, scalars, AffinePoint(x, y, inf), cfg)


def phase_k2(dc, n: int, cfg, rng, dev) -> dict:
    """K2 against its plain version at the main path's shape, on points
    that do not repeat and some at infinity."""
    from libff_tpu_torch.msm.insert import insert, insert_plain

    G = dc.g1
    d, pts, B = k2_inputs(dc, n, cfg, rng, dev)
    want, plain_ms = host_timed(lambda: insert_plain(G, d, pts, B))
    err = max_abs_err(insert(G, d, pts, B), want)
    del want
    res = {"name": "K2", "shape": list(d.shape) + [B], "max_abs_err": err,
           "points_at_infinity": int(pts[3].sum()),
           "zero_digits": int((d == 0).sum()), "plain_ms": plain_ms,
           "ms": event_ms(lambda: insert(G, d, pts, B), 3)}
    if err:
        fail(f"K2 disagrees with its plain version: {res}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from libff_tpu_torch import _build, convert, workload
    from libff_tpu_torch.curves.device import device_curve
    from libff_tpu_torch.msm.pippenger import default_config, msm_pippenger

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "env", **_build.env_report(), "device": name,
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    per_source = _build.build()
    ptxas = {p.stem: [ln.split("info    : ")[-1].strip()
                      for ln in p.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
             for p in sorted(_build.build_dir().glob("*.log"))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": per_source, "ptxas": ptxas})

    dc = device_curve("alt_bn128")
    G, F, cd = dc.g1, dc.fq, dc.cd
    rng = np.random.default_rng(SEED)

    k1e = phase_k1e(F, rng, dev)
    emit({"phase": "K1e", **k1e})
    k3 = phase_k3(G, rng, dev)
    emit({"phase": "K3", **k3})

    n = 1 << LOG2N
    cfg = default_config(n, dev)
    k2 = phase_k2(dc, n, cfg, rng, dev)
    emit({"phase": "K2", **k2})

    limbs, x, y = workload.msm_inputs(cd, n, SEED)
    scalars = convert.field_to_torch(limbs, dev)
    points = convert.affine_to_torch((x, y, np.zeros(n, dtype=bool)), dev)
    want = workload.oracle(cd, workload.class_sums(limbs))
    runs = []
    for run in range(1 + MSM_STEADY_RUNS):
        if run == 0:
            _build.LAUNCHES.clear()
        times: dict = {}
        t0 = time.perf_counter()
        R = msm_pippenger(G, scalars, points, 254, config=cfg,
                          phase_times=times)
        A = G.to_affine(R)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        times["to_affine"] = total - sum(times.values())
        if run == 0:
            launches = dict(_build.LAUNCHES)
        got = None if bool(A.inf) else (F.to_ints(A.x)[0], F.to_ints(A.y)[0])
        if got != want:
            fail(f"MSM run {run} gives {got}, the oracle {want}")
        runs.append({"seconds": total, "phases": times})
    # run 0 pays the first call's set-up (lazy module loading, allocator
    # growth); the steady runs give the median and quartiles
    steady = sorted(r["seconds"] for r in runs[1:])
    q1, med, q3 = np.percentile(steady, [25, 50, 75]).tolist()
    gpu = _build.env_report()["gpu"]
    emit({"phase": "msm", "curve": "alt_bn128", "group": "G1", "log2n": LOG2N,
          "config": cfg._asdict(), "equal_to_oracle": True,
          "first_run": runs[0], "steady_runs": len(steady),
          "seconds_median": med, "seconds_q1": q1, "seconds_q3": q3,
          "seconds_min": steady[0], "seconds_max": steady[-1],
          "phases_median": {k: float(np.median([r["phases"][k]
                                                for r in runs[1:]]))
                            for k in runs[0]["phases"]},
          "points_per_sec": n / med, "card": gpu})

    src = "libff_tpu_torch/csrc/"
    kernels = [
        {"name": "K1e", "route": "cuda", "source": src + "fp_ops.cu",
         "replaces": "libff_tpu/msm/pallas_insert.py:87",
         "ms": k1e["ops"]["mul"]["ms"], "plain_ms": k1e["ops"]["mul"]["plain_ms"],
         "shape": [F.n32, k1e["n"]], "max_abs_err": k1e["max_abs_err"]},
        {"name": "K2", "route": "cuda", "source": src + "insert.cu",
         "replaces": "libff_tpu/msm/pallas_insert3.py:74",
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "shape": k2["shape"],
         "max_abs_err": k2["max_abs_err"]},
        {"name": "K3", "route": "cuda", "source": src + "group_ops.cu",
         "replaces": "libff_tpu/curves/pallas_ops.py:66",
         "ms": k3["ops"]["padd"]["ms"], "plain_ms": k3["ops"]["padd"]["plain_ms"],
         "shape": [F.n32, k3["n"]], "max_abs_err": k3["max_abs_err"]},
    ]
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on the main path")
    emit({"kernels": kernels})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
