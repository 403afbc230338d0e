"""The batched-affine bucket-add experiment on the card: kernel K7e (port of
profile/affine_experiment.py).

    python3 -m libff_tpu_torch.affine_experiment [T] [Ls] [instances]

K2's insert adds each point to a projective bucket with the complete
mixed add (11 products, three bucket coordinates of traffic).  Affine
buckets would carry two coordinates and take a ~4-product add body, but
need a batched inversion of the lanes' denominators at every step.  The
harness times the three pieces over T sequential steps of L = Ls * 128
lanes (default T = 2048, Ls = 4):

- ``madd_body``: o <- X3 ^ Y3 ^ Z3 of ``rcb_madd_a0`` on the projective
  (o, a_t, b_t) and the affine (a_t, b_t) (affine_experiment.py:101-111);
- ``affine_body``: the affine add body with the stand-in inverse b_t, the
  doubling numerator where x1 == x2, o <- x3 ^ y3 (:116-135);
- ``lane_inv``: per step the 2-D inclusive prefix products of d = a_t
  over the (Ls, 128) tile (a 128-lane scan in each row, then a scan over
  the rows), the suffix products of each 128-lane row, acc = pre^(p-2)
  by the ladder over p - 2's bits, o = (pre * suf) * acc (:149-187).  The
  kernel also returns ``chk``, the XOR of every step's o: the steps are
  independent and only the last reaches o, so ``chk`` is what shows that
  no step was dropped.

One instance of the reference is 512 lanes, under 1% of the card, so the
kernels run I independent instances side by side, each on its own inputs
((I, T, 8, L) canonical nonzero residues, 32-bit limbs) with its own o.
By default each body runs the instances that fill two whole waves of its
kernel at its occupancy (:func:`default_instances`; on an H100 madd and
lane_inv 264, affine 462, 28.9 GiB of inputs for the largest), so that no
partial wave dilutes its time; ``instances`` sets one count for all.  On
a CUDA card (it refuses to run without one) it prints one JSON line with
the reference's keys (ns per element is a body's time over I * T * L, as
:189-194 has it), the card's name and power limit, each body's I and its
kernel's registers, spills, occupancy and waves, each body's bound and
its share of it, and each body's time at T over its time at T/2.

``accept`` is the reference code's rule, affine_body + lane_inv < madd *
(1 + traffic_credit) (:193, :205); its docstring (:26-27) states (1 -
traffic_credit), which the code does not run.

Each kernel has its plain version here (the same body on the port's
``PlainField`` CIOS arithmetic), which the CPU tests and ``chip_smoke.py``
hold it against bit for bit; a CPU tensor runs the plain version, a CUDA
tensor the kernel.
"""

from __future__ import annotations

import ctypes
import json
import math
import sys

import numpy as np
import torch

from . import _build
from .curves import formulas as fml
from .curves.device import device_curve
from .fields.fp import kernel_device, ladder, to16, to32, window_products
from .issue_rates import bound, imad_rates, imads
from .timing import event_ms

T_DEFAULT, LS_DEFAULT = 2048, 4
ROW = 128                      # lanes of a row, the TPU's vreg width
MAX_ROWS = 4                   # lane_inv: one block of Ls * 128 <= 512 threads
TRAFFIC_CREDIT = 0.2           # affine_experiment.py:191
SEED = 7
# body -> (its code in csrc/affine_experiment.cu, its launch-count name)
BODIES = {"madd": (0, "K7e madd"), "affine": (1, "K7e affine"),
          "lane_inv": (2, "K7e inv")}
MADD_PRODUCTS = 11             # rcb_madd_a0, b3 = 9 by additions
AFFINE_PRODUCTS = 3            # 4 where x1 == x2 (never, on random inputs)
WAVES = 2                      # whole waves the default instance count fills
TRIALS = 3                     # a time is the best of 3 calls (:61-69)
PLAIN_CHUNK = 1 << 20          # elements lane_inv_plain runs at once
NOTE = ("accept = affine_body + lane_inv < madd * (1 + traffic_credit), the "
        "reference's code (affine_experiment.py:193, :205); its docstring "
        "(:26-27) states (1 - traffic_credit), and the code's form is the one "
        "kept. The Fermat ladder runs per lane, in each thread's registers.")
_ARGS = [ctypes.c_int, _build.VP, _build.VP, _build.VP, _build.VP,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
         _build.U32P, ctypes.c_uint32, ctypes.c_int, _build.VP]
_INFO_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.POINTER(ctypes.c_int)]


def _check(F, a: torch.Tensor, b: torch.Tensor | None = None) -> None:
    """a (and b): (I, T, n32, L) int32 on one device, L a multiple of 128,
    each step's (n32, L) words contiguous."""
    for x in (a,) if b is None else (a, b):
        if x.dtype != torch.int32:
            raise TypeError("operands are torch.int32")
        if x.ndim != 4 or x.shape[2] != F.n32 or x.shape[3] % ROW:
            raise ValueError(f"operands are (I, T, {F.n32}, Ls * 128), not "
                             f"{tuple(x.shape)}")
        if x.stride()[1:] != (F.n32 * x.shape[3], x.shape[3], 1):
            raise ValueError("each instance's steps are contiguous")
    if b is not None and (a.shape != b.shape or a.device != b.device
                          or a.stride() != b.stride()):
        raise ValueError("operands differ in shape, strides or device")


def _step(x: torch.Tensor, t) -> torch.Tensor:
    """Step(s) t of an (I, T, n32, L) array as int64 16-bit limbs, limb
    axis first: (n16, I, L), or (n16, I, S, L) for a slice t."""
    y = x[:, t]
    return to16(y, y.ndim - 2).movedim(-2, 0)


def _out(o: torch.Tensor) -> torch.Tensor:
    """(n16, I, L) limbs -> the (I, n32, L) int32 output."""
    return to32(o.movedim(0, 1), 1)


# -- the plain versions ------------------------------------------------------

def _zero_o(a: torch.Tensor) -> torch.Tensor:
    """o = 0 as (n16, I, L) limbs."""
    I, _, n32, L = a.shape
    return torch.zeros((2 * n32, I, L), dtype=torch.int64, device=a.device)


def madd_body_plain(G, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of K7e's madd on any device: from o = 0, at each
    step (X3, Y3, Z3) = rcb_madd_a0 of the projective (o, a_t, b_t) and
    the affine (a_t, b_t) on the group's plain field, o <- X3 ^ Y3 ^ Z3.
    Returns o, (I, n32, L)."""
    _check(G.F, a, b)
    P = G.F.plain
    o = _zero_o(a)
    for t in range(a.shape[1]):
        x, y = _step(a, t), _step(b, t)
        X3, Y3, Z3 = fml.rcb_madd_a0(P, o, x, y, x, y, G._b3_host)
        o = X3 ^ Y3 ^ Z3
    return _out(o)


def affine_body_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of K7e's affine body on any device: from o = 0, at
    each step (x1, y1) = (o, a_t), (x2, y2) = (a_t, b_t), dinv = b_t; num
    = 3 x1^2 where x1 == x2 (every limb), else y2 - y1; lam = num * dinv,
    x3 = (lam^2 - x1) - x2, y3 = lam (x1 - x3) - y1, o <- x3 ^ y3."""
    _check(F, a, b)
    P = F.plain
    o = _zero_o(a)
    for t in range(a.shape[1]):
        x2, y2 = _step(a, t), _step(b, t)
        x1, y1, dinv = o, x2, y2
        x_eq = (x1 == x2).all(dim=0, keepdim=True)
        sq = P.mul(x1, x1)
        num = torch.where(x_eq, P.add(P.add(sq, sq), sq), P.sub(y2, y1))
        lam = P.mul(num, dinv)
        x3 = P.sub(P.sub(P.mul(lam, lam), x1), x2)
        y3 = P.sub(P.mul(lam, P.sub(x1, x3)), y1)
        o = x3 ^ y3
    return _out(o)


def lane_scans(P, d: torch.Tensor):
    """(pre, suf) of the (n16, ..., Ls, 128) limbs d on the plain field P,
    as the reference's roll butterflies compute them (torch.roll moves to
    higher indices, as pltpu.roll does): pre the inclusive prefix products
    over each row's 128 lanes, then over the Ls rows (a 2-D prefix), suf
    the suffix products over each row's 128 lanes."""
    Ls = d.shape[-2]
    lane = torch.arange(ROW, device=d.device)
    row = torch.arange(Ls, device=d.device)[:, None]
    pre, s = d, 1
    while s < ROW:
        pre = torch.where(lane >= s, P.mul(pre, torch.roll(pre, s, -1)), pre)
        s *= 2
    s = 1
    while s < Ls:
        pre = torch.where(row >= s, P.mul(pre, torch.roll(pre, s, -2)), pre)
        s *= 2
    suf, s = d, 1
    while s < ROW:
        suf = torch.where(lane < ROW - s,
                          P.mul(suf, torch.roll(suf, ROW - s, -1)), suf)
        s *= 2
    return pre, suf


def _lane_inv_steps(F, d: torch.Tensor) -> torch.Tensor:
    """o of every step of the (n16, I, S, Ls, 128) limbs d: (pre * suf) *
    pre^(p-2), the power by the ladder over p - 2's bits below the leading
    one (affine_experiment.py:183-186)."""
    P = F.plain
    pre, suf = lane_scans(P, d)
    acc = ladder(P.sqr, P.mul, pre, F.p - 2)
    return P.mul(P.mul(pre, suf), acc)


def lane_inv_plain(F, a: torch.Tensor):
    """The plain version of K7e's lane inversion on any device: (o, chk),
    each (I, n32, L): o is the last step's (pre * suf) * pre^(p-2), chk
    the XOR of every step's.  Steps are independent; they run
    PLAIN_CHUNK elements at a time."""
    _check(F, a)
    I, T, _, L = a.shape
    o = chk = _zero_o(a)
    S = max(1, PLAIN_CHUNK // max(1, I * L))
    for t0 in range(0, T, S):
        d = _step(a, slice(t0, min(T, t0 + S)))
        steps = _lane_inv_steps(F, d.reshape(d.shape[:3] + (L // ROW, ROW)))
        steps = steps.reshape(d.shape)
        for s in range(steps.shape[2]):
            chk = chk ^ steps[:, :, s]
        o = steps[:, :, -1]
    return _out(o), _out(chk)


# -- the kernels --------------------------------------------------------------

def _kernel_field(F, a: torch.Tensor, what: str) -> bool:
    """kernel_device for K7e, whose kernels are built for alt_bn128's Fq
    only."""
    if not kernel_device(a, F.n32, what):
        return False
    if F.p != device_curve("alt_bn128").q:
        raise NotImplementedError(f"{what} is built for alt_bn128's Fq")
    return True


def _launch(name: str, F, a: torch.Tensor, b: torch.Tensor,
            chk: bool = False):
    code, count = BODIES[name]
    I, T, _, L = a.shape
    if name == "lane_inv" and L > MAX_ROWS * ROW:
        raise ValueError(f"lane_inv runs at most {MAX_ROWS} rows, not "
                         f"{L // ROW}")
    out = torch.empty((I, F.n32, L), dtype=torch.int32, device=a.device)
    c = torch.empty_like(out) if chk else out
    fn = _build.function("affine_experiment", "affine_body", _ARGS)
    _build.launch(fn, count, a.device, code, _build.ptr(out), _build.ptr(c),
                  _build.ptr(a), _build.ptr(b), I, T, L, a.stride(0), F.p_c,
                  F.inv32, a.get_device(), _build.stream_ptr(a))
    _build.LAUNCHES[count] += 1
    return (out, c) if chk else out


def madd_body(G, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel K7e madd on the (I, T, 8, L) canonical arrays a, b of group
    G (alt_bn128 G1); returns o, (I, 8, L)."""
    _check(G.F, a, b)
    if not _kernel_field(G.F, a, "K7e madd"):
        return madd_body_plain(G, a, b)
    if G._b3_host != 9:
        raise NotImplementedError("K7e madd is built for b3 = 9")
    return _launch("madd", G.F, a, b)


def affine_body(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel K7e affine on the (I, T, 8, L) canonical arrays a, b of
    alt_bn128's Fq; returns o, (I, 8, L)."""
    _check(F, a, b)
    if not _kernel_field(F, a, "K7e affine"):
        return affine_body_plain(F, a, b)
    return _launch("affine", F, a, b)


def lane_inv(F, a: torch.Tensor):
    """Kernel K7e lane_inv on the (I, T, 8, L) canonical nonzero array a
    of alt_bn128's Fq, L = Ls * 128 with Ls <= 4; returns (o, chk), each
    (I, 8, L)."""
    _check(F, a)
    if not _kernel_field(F, a, "K7e inv"):
        return lane_inv_plain(F, a)
    return _launch("lane_inv", F, a, a, chk=True)


# -- the harness on the card ------------------------------------------------

def kernel_info(Ls: int, dev) -> dict:
    """Per body: registers and spill bytes a thread, threads a block,
    blocks resident an SM, SMs, and the instances one wave holds."""
    fn = _build.function("affine_experiment", "affine_body_info", _INFO_ARGS)
    out = {}
    for name, (code, _) in BODIES.items():
        threads = Ls * ROW if name == "lane_inv" else ROW
        v = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            rc = fn(code, threads, dev.index or 0, v)
        if rc != 0:
            raise RuntimeError(f"K7e {name}: CUDA error {rc} in its info")
        regs, spill, per_sm, sms = list(v)
        blocks_per_instance = 1 if name == "lane_inv" else Ls
        out[name] = {"registers": regs, "spill_bytes": spill,
                     "threads_per_block": threads, "blocks_per_sm": per_sm,
                     "sms": sms, "instances_per_wave":
                     per_sm * sms / blocks_per_instance}
    return out


def default_instances(info: dict) -> dict:
    """Per body, the instances that fill WAVES whole waves of its kernel
    at its occupancy (a wave holding a fraction of an instance rounds
    up)."""
    return {k: math.ceil(WAVES * v["instances_per_wave"])
            for k, v in info.items()}


def random_inputs(F, I: int, T: int, L: int, seed: int, dev):
    """Two (I, T, n32, L) arrays of canonical nonzero residues: uniform
    limbs under p's top limb, made on dev by a generator seeded from a
    numpy seed (an all-zero element becomes 1)."""
    g = torch.Generator(device=dev)
    g.manual_seed(int(np.random.default_rng(seed).integers(1 << 62)))
    top = int(F.p_limbs[-1])
    out = []
    for _ in range(2):
        x = torch.empty((I, T, F.n32, L), dtype=torch.int32, device=dev)
        for i in range(I):
            x[i, :, :-1] = torch.randint(-1 << 31, 1 << 31,
                                         (T, F.n32 - 1, L), generator=g,
                                         dtype=torch.int32, device=dev)
            x[i, :, -1] = torch.randint(0, top, (T, L), generator=g,
                                        dtype=torch.int32, device=dev)
            z = (x[i] == 0).all(dim=1)
            x[i, :, 0] = torch.where(z, 1, x[i, :, 0])
        out.append(x)
    return tuple(out)


def lane_inv_products(Ls: int, p: int) -> float:
    """Products per element that a lane_inv step needs, whatever the scan
    schedule: the 2-D prefix (127 in each row, then 128 for each row
    after the first), the row suffix (127 in each row), the inverse (the
    shortest sliding-window chain for p - 2, fewer than the ladder's
    squarings and products by p - 2's bits) and the two of o."""
    L = Ls * ROW
    return (2 * (L - Ls) + (Ls - 1) * ROW) / L + window_products(p - 2) + 2


def bounds(T: int, Ls: int, instances: dict, p: int, rates: dict) -> dict:
    """Each body's bound (issue_rates.bound) on its instances of T steps:
    its products' multiply-adds, and its bytes: a_t and b_t read at each
    step (lane_inv reads a_t only), o written once (and lane_inv's
    chk)."""
    work = {"madd": (MADD_PRODUCTS, 64, 1), "affine": (AFFINE_PRODUCTS, 64, 1),
            "lane_inv": (lane_inv_products(Ls, p), 32, 2)}
    out = {}
    for k, (prod, read, outs) in work.items():
        n = instances[k] * T * Ls * ROW
        out[k] = bound(n * read + outs * 32 * instances[k] * Ls * ROW,
                       imads(n * prod), rates)
    return out


def best_ms(fn, warm: bool = True):
    """(the best device ms of TRIALS timed calls of fn, after a warm-up
    call unless warm is False, as affine_experiment.py:61-69 takes it; the
    last call's output)."""
    last = [fn() if warm else None]

    def call():
        last[0] = fn()

    return min(event_ms(call, 1, warm=False) for _ in range(TRIALS)), last[0]


def report(ms: dict, half_ms: dict, T: int, Ls: int, instances: dict,
           rates: dict, p: int) -> dict:
    """The harness's numbers from each body's ms at T on its instances
    (and at T/2, where half_ms has it): the reference's keys, the bounds
    and shares."""
    L = Ls * ROW
    per = {k: 1e6 / (instances[k] * T * L) for k in ms}   # ms -> ns/element
    ns = {k: v * per[k] for k, v in ms.items()}
    total = ns["affine"] + ns["lane_inv"]
    bnd = bounds(T, Ls, instances, p, rates)
    out = {"metric": "affine_bucket_experiment", "platform": "gpu", "T": T,
           "Ls": Ls, "lanes": L, "instances": instances,
           "input_bytes": 2 * max(instances.values()) * T * L * 32,
           "madd_ns_per_el": ns["madd"],
           "affine_body_ns_per_el": ns["affine"],
           "lane_inv_ns_per_el": ns["lane_inv"],
           "affine_total_ns_per_el": total,
           "traffic_credit": TRAFFIC_CREDIT,
           "accept": bool(total < ns["madd"] * (1 + TRAFFIC_CREDIT)),
           "note": NOTE, "ms": ms, "bounds": bnd,
           "lane_inv_products_per_el": lane_inv_products(Ls, p)}
    for k, key in (("madd", "madd"), ("affine", "affine_body"),
                   ("lane_inv", "lane_inv")):
        out[f"{key}_bound_ns_per_el"] = bnd[k]["bound_ms"] * per[k]
        out[f"{key}_share_of_bound"] = bnd[k]["bound_ms"] / ms[k]
        if k in half_ms:
            out[f"{key}_t_over_half_t"] = ms[k] / half_ms[k]
    return out


def measure(T: int = T_DEFAULT, Ls: int = LS_DEFAULT,
            instances: int | None = None):
    """The harness on the first card: (the report, the inputs (a, b), each
    body's output of its timed calls at T).  Body k runs on the first
    report["instances"][k] instances of a, b: `instances` for every body,
    or by default_instances.  Each body is also timed on the first T/2
    steps."""
    if not 1 <= Ls <= MAX_ROWS or T < 2:
        raise ValueError(f"Ls in 1..{MAX_ROWS} and T >= 2, not {Ls}, {T}")
    dev = torch.device("cuda", 0)
    dc = device_curve("alt_bn128")
    F = dc.fq
    _build.build()
    info = kernel_info(Ls, dev)
    inst = ({k: instances for k in BODIES} if instances
            else default_instances(info))
    for k, v in info.items():
        v["waves"] = inst[k] / v["instances_per_wave"]
    a, b = random_inputs(F, max(inst.values()), T, Ls * ROW, SEED, dev)
    runs = {"madd": lambda x, y: madd_body(dc.g1, x, y),
            "affine": lambda x, y: affine_body(F, x, y),
            "lane_inv": lambda x, y: lane_inv(F, x)}
    ms, half_ms, outs = {}, {}, {}
    for name, fn in runs.items():
        x, y = a[:inst[name]], b[:inst[name]]
        ms[name], outs[name] = best_ms(lambda: fn(x, y))
        h = T // 2
        half_ms[name] = best_ms(lambda: fn(x[:, :h], y[:, :h]),
                                warm=False)[0]
    rep = {**report(ms, half_ms, T, Ls, inst, imad_rates(dev), F.p),
           "device": torch.cuda.get_device_name(dev),
           "card": _build.card_name_power(), "kernels": info}
    return rep, (a, b), outs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("affine_experiment: needs a CUDA card", file=sys.stderr)
        return 2
    args = [int(x) for x in argv]
    T = args[0] if args else T_DEFAULT
    Ls = args[1] if len(args) > 1 else LS_DEFAULT
    instances = args[2] if len(args) > 2 else None
    print(json.dumps(measure(T, Ls, instances)[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
