"""Issue rates of the card's 32-bit integer instructions: kernel K7c (port
of profile/vpu_issue.py).

    python3 -m libff_tpu_torch.issue_rates

On a CUDA card (it refuses to run without one) it runs each body on
:func:`elements` words, R = 1024 op groups each: 16 whole waves of full
occupancy (4,325,376 words on 132 SMs), where the JAX shape's 2^21 would
leave a partial last wave that dilutes a rate.  It prints one JSON line:
for each body its ns per op (the best of TRIALS timings, as
vpu_issue.py takes it) and its ops per clock per SM at the SM clock
nvidia-smi read under load.  ``IMAD_PER_CLOCK_PER_SM`` holds the rates
that the bounds of ``chip_smoke.py`` charge, and ``check_imad`` holds
these measurements to them.  The bodies
(the op counted):

- ``mul_lo``, ``mul_hi``: 8 independent chains of mul.lo / mul.hi (one
  multiply);
- ``carry``: fp.cuh's carry-chain rows as its CIOS runs them (one IMAD of
  mad.lo.cc/madc.lo.cc/madc.hi.cc, 16 a group, serial through the carry
  flag);
- ``cheap``: 8 independent chains of add, and, shift (one op);
- ``mac``: vpu_issue.py's group p = x*b, lo += p & 0xFFFF, hi += p >> 16
  (one group of 1 multiply and 4 cheap ops);
- ``chain_1`` .. ``chain_8``: 1, 2, 4, 8 interleaved serial mad.lo chains
  (one mad.lo), timed both at full occupancy (one element a thread) and at
  4 warps a SM (one 128-thread block a SM, one warp a scheduler), where
  a lone chain shows the multiply's latency.

Each body has its plain version here (the same u32 op sequence in int64
tensors masked to 32 bits), which the CPU tests and ``chip_smoke.py`` hold
it against; a CPU tensor runs the plain version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from . import _build
from .fields.fp import (MASK16, MASK32, as_int32, as_u32, kernel_device,
                        mul_hi32, mul_lo32)
from .timing import clock_under_load, timed_output

R = 1024                    # vpu_issue.py: T = 2048 of (Ls = 8, 128)
# a body's elements: WAVES whole waves of a card's full occupancy (2048
# resident threads a SM, in 256-thread blocks)
WAVES, THREADS_PER_SM = 16, 2048
# timings a body's time is the best of, as vpu_issue.py's _time takes it;
# each is the mean of 5 launches
TRIALS = 3
# name -> (its code in csrc/issue_rates.cu, PTX ops per op group counted)
BODIES = {"mul_lo": (0, 1), "mul_hi": (1, 1), "carry": (2, 1),
          "cheap": (3, 3), "mac": (4, 1), "chain_1": (5, 1),
          "chain_2": (6, 1), "chain_4": (7, 1), "chain_8": (8, 1)}
# 32-bit multiply-adds a clock per SM by kind, the peak the bounds
# charge: "lo" (mul.lo, mad.lo: IMAD) the 64 that the CUDA C++ Programming
# Guide gives compute capability 9.0, "hi" (mul.hi, mad.hi: IMAD.HI) half
# of it, as the mul_hi body measures on an H100
IMAD_PER_CLOCK_PER_SM = {"lo": 64, "hi": 32}
# the largest relative distance of a measured rate from those peaks
IMAD_RATE_TOLERANCE = 0.05
# the card's memory rate for the bounds: 3.35 TB/s of HBM3 (H100 SXM data
# sheet)
HBM_BYTES_PER_S = 3.35e12
# multiply-adds of one 8-limb Montgomery product by kmul and kind (lo:
# mul.lo/mad.lo, hi: mul.hi/mad.hi), counted from fp.cuh's PTX: CIOS 8
# rows of 8 mad.lo, 8 mad.hi, the quotient's mul.lo, 8 mad.lo and 8
# mad.hi; SOS the same ops in another order; SOS2 the product's 64 + 64,
# then 4 waves of a 64-bit quotient (3 lo, 1 hi) and 16 mad.lo + 16
# mad.hi.  K7a's synthetic product has CIOS's mix.
IMAD_PER_FP_MUL = {"cios": {"lo": 136, "hi": 128},
                   "sos": {"lo": 136, "hi": 128},
                   "sos2": {"lo": 140, "hi": 132}}
_ARGS = [ctypes.c_int, _build.VP, _build.VP, _build.VP, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _build.VP]


def imad_rates(dev) -> dict:
    """Multiply-adds a second by kind ("lo", "hi"): each kind's peak a
    clock per SM times the SM count and the card's maximum SM clock."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, check=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = float(r.stdout.strip().splitlines()[0]) * 1e6 * sms
    return {kind: v * per_sm for kind, v in IMAD_PER_CLOCK_PER_SM.items()}


def imad_per_product(kmul: str = "cios", n32: int = 8) -> dict:
    """The multiply-adds of one Montgomery product by kind: the table's at
    8 limbs; at another width CIOS's and SOS's n32 rows of 2 n32 + 1 lo
    (the quotient's mul.lo among them) and 2 n32 hi (300 and 288 at 12),
    SOS2's product (n32^2 of each) and n32 / 2 waves of a 64-bit quotient
    (3 lo, 1 hi) and 2 n32 of each (306 and 294 at 12)."""
    if n32 == 8:
        return IMAD_PER_FP_MUL[kmul]
    if kmul == "sos2":
        return {"lo": 2 * n32 * n32 + 3 * n32 // 2,
                "hi": 2 * n32 * n32 + n32 // 2}
    return {"lo": n32 * (2 * n32 + 1), "hi": 2 * n32 * n32}


def imads(products: float, kmul: str = "cios", n32: int = 8) -> dict:
    """The multiply-adds of `products` Montgomery products of n32 limbs,
    by kind."""
    return {k: v * products
            for k, v in imad_per_product(kmul, n32).items()}


def bound(nbytes: float, imad: dict, rates: dict) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the multiply-adds, each kind over its rate
    (imad_rates)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / rates[k] for k, n in imad.items()) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "imads": sum(imad.values()),
            "imads_by_kind": imad}


def _check(name: str, a: torch.Tensor, b: torch.Tensor, R: int) -> None:
    if name not in BODIES:
        raise ValueError(f"unknown body {name!r}; one of {list(BODIES)}")
    if a.shape != b.shape or a.ndim != 1 or a.device != b.device:
        raise ValueError("a and b are (n,) words on one device")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("a and b are torch.int32")
    if R < 0 or R % 16:
        raise ValueError(f"R is a multiple of 16, not {R}")


def issue_body(name: str, a: torch.Tensor, b: torch.Tensor, R: int = R,
               warps_per_sm: int | None = None) -> torch.Tensor:
    """Kernel K7c: body `name` over R op groups for each element of the
    (n,) words a, b; returns the (n,) words it folds into.  warps_per_sm:
    one block of that many warps a SM walks all elements; None: one
    element a thread in 256-thread blocks."""
    _check(name, a, b, R)
    if not kernel_device(a, 8, "K7c"):
        return issue_body_plain(name, a, b, R)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    blocks, threads = 0, 256
    if warps_per_sm is not None:
        props = torch.cuda.get_device_properties(a.device)
        blocks = props.multi_processor_count
        threads = 32 * warps_per_sm
    fn = _build.function("issue_rates", "issue_body", _ARGS)
    _build.launch(fn, f"K7c {name}", a.device, BODIES[name][0],
                  _build.ptr(out), _build.ptr(a), _build.ptr(b), a.shape[0],
                  R, blocks, threads, a.get_device(), _build.stream_ptr(a))
    _build.LAUNCHES["K7c"] += 1
    return out


def _chains(a, K: int, R: int, op):
    x = (a[None] + torch.arange(K, device=a.device)[:, None]) & MASK32
    for _ in range(R // K):
        x = op(x)
    acc = x[0]
    for i in range(1, K):
        acc = acc ^ x[i]
    return acc


def issue_body_plain(name: str, a: torch.Tensor, b: torch.Tensor,
                     R: int = R) -> torch.Tensor:
    """The plain version of K7c on any device: issue_rates.cu's op
    sequence for body `name` in int64 tensors masked to 32 bits."""
    _check(name, a, b, R)
    a, b = as_u32(a), as_u32(b)
    if name == "mul_lo":
        out = _chains(a, 8, R, lambda x: mul_lo32(x, b))
    elif name == "mul_hi":
        out = _chains(a, 8, R, lambda x: mul_hi32(x, b))
    elif name == "cheap":
        out = _chains(a, 8, R, lambda x: ((x + b) & MASK16) >> 1)
    elif name.startswith("chain_"):
        out = _chains(a, int(name[6:]), R,
                      lambda x: (mul_lo32(x, b) + a) & MASK32)
    elif name == "mac":
        k = torch.arange(4, device=a.device)[:, None]
        lo, hi = (a[None] + k) & MASK32, (b[None] + k) & MASK32
        for _ in range(R // 4):
            p = mul_lo32(lo, b)
            lo = (lo + (p & MASK16)) & MASK32
            hi = (hi + (p >> 16)) & MASK32
        out = lo[0] ^ hi[0]
        for i in range(1, 4):
            out = out ^ lo[i] ^ hi[i]
    else:
        out = _carry_rows(a, b, R)
    return as_int32(out)


def _carry_rows(a, b, R):
    """fp.cuh's two CIOS rows on t[0..9], R / 16 times, carries by hand."""
    t = [(a + k) & MASK32 for k in range(10)]
    y = [(b + j) & MASK32 for j in range(8)]
    lo = [mul_lo32(a, yj) for yj in y]
    hi = [mul_hi32(a, yj) for yj in y]
    for _ in range(R // 16):
        c = 0
        for j in range(8):                 # t[0..7] += lo(a y_j); t8, t9
            v = t[j] + lo[j] + c
            t[j], c = v & MASK32, v >> 32
        v = t[8] + c
        t[8], t[9] = v & MASK32, v >> 32
        c = 0
        for j in range(8):                 # t[1..8] += hi(a y_j); t9
            v = t[j + 1] + hi[j] + c
            t[j + 1], c = v & MASK32, v >> 32
        t[9] = (t[9] + c) & MASK32
    out = t[0]
    for k in range(1, 10):
        out = out ^ t[k]
    return out


def elements(dev) -> int:
    """The words a body runs on: WAVES whole waves of full occupancy on
    the card dev."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return WAVES * THREADS_PER_SM * sms


def rates(a: torch.Tensor, b: torch.Tensor, R: int = R):
    """Every body's rate on the card that holds the (n,) words a, b (see
    the module docstring).  Returns (the rates, the output of each timed
    launch by the rates' body key)."""
    dev = a.device
    n = a.shape[0]
    mhz = clock_under_load(lambda: issue_body("mul_lo", a, b, R))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {"device": torch.cuda.get_device_name(dev),
           "card": _build.card_name_power(), "sm_clock_mhz": mhz, "sms": sms,
           "elements": n, "op_groups": R,
           "imad_per_clock_per_sm": IMAD_PER_CLOCK_PER_SM, "bodies": {}}
    outs = {}
    for name, (_, per_group) in BODIES.items():
        ops = n * R * per_group
        runs = {"full": None}
        if name.startswith("chain_"):
            runs["4_warps_per_sm"] = 4
        for key, warps in runs.items():
            ms = float("inf")
            for _ in range(TRIALS):
                t, outs[f"{name} {key}"] = timed_output(
                    lambda: issue_body(name, a, b, R, warps), 5)
                ms = min(ms, t)
            res["bodies"][f"{name} {key}"] = {
                "ms": ms, "ns_per_op": ms * 1e6 / ops,
                "ops_per_clock_per_sm": ops / (ms * 1e-3 * mhz * 1e6 * sms)}
    return res, outs


def check_imad(res: dict) -> dict:
    """Each multiply kind's measured rate (the mul_lo and mul_hi bodies at
    full occupancy in `res`, from :func:`rates`) over the peak it is
    charged; raises if one is more than IMAD_RATE_TOLERANCE away."""
    out = {}
    for kind, peak in IMAD_PER_CLOCK_PER_SM.items():
        got = res["bodies"][f"mul_{kind} full"]["ops_per_clock_per_sm"]
        out[kind] = got / peak
        if abs(got / peak - 1) > IMAD_RATE_TOLERANCE:
            raise RuntimeError(
                f"mul.{kind} issues {got:.2f} a clock per SM, more than "
                f"{IMAD_RATE_TOLERANCE:.0%} away from the {peak} the bounds "
                f"charge")
    return out


def measure(R: int = R) -> dict:
    """Every body's rate on the first card, on random words."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    a, b = (torch.from_numpy(rng.integers(0, 1 << 32, elements(dev),
                                          dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(dev)
            for _ in range(2))
    _build.build()
    return rates(a, b, R)[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("issue_rates: needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(measure()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
