"""The field-mul roofline on the card: kernels K7a, K7b and K7d (port of
profile/roofline.py and of profile/g2_phases.py:62 ``fq2_mul_ns``).

    python3 -m libff_tpu_torch.roofline [log2n] [impls]

On a CUDA card (it refuses to run without one) it prints one JSON line,
with the JAX package's keys where they mean the same thing
(roofline.py:321-339):

- ``roofline_ns``: K7a, ns per synthetic product: fp.cuh's CIOS op mix
  with its dependences removed, the no-stall bound (roofline.py:65), at
  2^22 elements, 16 products each;
- ``field_mul_cios_ns`` (roofline.py's ``field_mul_pallas_ns``),
  ``field_mul_sos_ns``, ``field_mul_sos2_ns``: K7b, ns per real product
  in 8 serial chains at 2^23 elements, 32 products each (roofline.py:158);
- ``field_mul_k1e_ns`` (roofline.py's ``field_mul_xla_ns``): 8 chained
  ``F.mul`` calls, each a K1e launch, at 2^log2n elements;
- ``field_mul_insert_kernel_ns``: one K2 G1 pass under the port's
  default configuration at 2^min(log2n, 18) points over its mixed adds
  times 11 products (roofline.py:207-242);
- ``lone_product_ns``: K7b lone, ns of one lone dependent CIOS product:
  one element's serial chain timed at LONE_REPS and LONE_REPS / 2
  products, the difference over LONE_REPS / 2 (the launch cancels); the
  latency of the port's own one-thread product, which a chain of
  dependent products pays at each link (not a bound of the card: a
  shorter product would lower it);
- ``fq2_mul_<impl>_ns``: K7d, ns per Fq2 product in 4 chains at 2^21
  elements, 8 products each (g2_phases.py:62-103);
- ``ratio`` (best product over the bound), ``production_ratio`` (the
  insert's over the bound), ``target`` 1.3 and ``ok``; the card's name
  and power limit and the SM clock nvidia-smi read under load;
- ``sass``: the multiply-adds the card runs for a product, counted in the
  kernels' SASS where the toolkit has cuobjdump (:func:`sass_report`).

``impls`` is a comma-separated subset of cios,sos,sos2 (default all).
Each kernel has its plain version here, which the CPU tests and
``chip_smoke.py`` hold it against bit for bit; a CPU tensor runs the plain
version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import ctypes
import json
import re
import sys

import numpy as np
import torch

from . import _build, workload
from .curves.device import device_curve
from .fields.fp import (KMULS, MASK32, as_int32, as_u32, check_kmul,
                        kernel_device, mul_hi32, mul_lo32, to16, to32)
from .fields.tower import check_nr
from .msm import digits as dig
from .msm.insert import insert
from .msm.pippenger import _prepare, default_config
from .timing import clock_under_load, event_ms, timed_output

# the JAX shapes: elements (T * Ls * 128) and rounds of the chains
SOL_N, SOL_REPS = 1 << 22, 16          # K7a: T = 8192, Ls = 4; 16 products
CHAIN_N, CHAIN_REPS = 1 << 23, 4       # K7b: T = 8192, Ls = 8; 4 x 8 = 32
FQ2_N, FQ2_REPS = 1 << 21, 2           # K7d: T = 4096, Ls = 4; 2 x 4 = 8
CHAINS = {1: 8, 2: 4}                  # chains an element, by el_ndim
LONE_REPS = 2048                       # K7b lone: products of the long run
LONE_PRODUCTS = {8: ("cios",), 12: ("cios", "eo"),   # K7b lone's, by n32
                 24: ("cios",)}
MADDS_MULS = 11                        # products in K2's G1 mixed add
TARGET = 1.3

_SOL_ARGS = [_build.VP, _build.VP, _build.VP, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, _build.VP]
_CHAIN_ARGS = [ctypes.c_int, _build.VP, _build.VP, _build.VP,
               ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _build.U32P,
               ctypes.c_uint32, ctypes.c_int, _build.VP]
_LONE_ARGS = _CHAIN_ARGS[1:]


def _check_pair(a: torch.Tensor, b: torch.Tensor, shape: tuple) -> None:
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("operands differ in shape or device")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("operands are torch.int32")
    if a.ndim != len(shape) + 1 or tuple(a.shape[:-1]) != shape:
        raise ValueError(f"operands are {shape} + (N,), not "
                         f"{tuple(a.shape)}")


# -- K7a: the no-stall op mix ------------------------------------------------

def sol_mix(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Kernel K7a: `reps` synthetic products (fp.cuh's CIOS op mix, its
    dependences removed) on each element of the (8, N) words a, b;
    returns the (8, N) words they fold into."""
    _check_pair(a, b, (8,))
    if not kernel_device(a, 8, "K7a"):
        return sol_mix_plain(a, b, reps)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    fn = _build.function("roofline", "sol_mix", _SOL_ARGS)
    _build.launch(fn, "K7a sol_mix", a.device, _build.ptr(out), _build.ptr(a),
                  _build.ptr(b), a.shape[-1], reps, a.get_device(),
                  _build.stream_ptr(a))
    _build.LAUNCHES["K7a"] += 1
    return out


def sol_mix_plain(a: torch.Tensor, b: torch.Tensor,
                  reps: int) -> torch.Tensor:
    """The plain version of K7a on any device: roofline.cu's op sequence
    in int64 tensors masked to 32 bits, each row's 8 independent
    accumulator updates as one tensor op."""
    _check_pair(a, b, (8,))
    x, y = as_u32(a), as_u32(b)
    lo, hi, s = x.clone(), y.clone(), x[:6].clone()
    for _ in range(reps):
        for i in range(8):
            lo = (mul_lo32(x[i], y) + lo) & MASK32
            hi = (mul_hi32(x[i], y) + hi) & MASK32
            m = mul_lo32(x[i], y[7 - i])
            lo = (mul_lo32(m, y) + lo) & MASK32
            hi = (mul_hi32(m, y) + hi) & MASK32
            s = (s + lo[:6]) & MASK32
        d = (lo - hi) & MASK32
        d8 = (s[0] - s[1]) & MASK32
        lo = torch.where(d8 == 0, d, lo)
    out = lo ^ hi
    out[:6] ^= s
    return as_int32(out)


# -- K7b and K7d: chains of real products -------------------------------------

def mul_chain(F, a: torch.Tensor, b: torch.Tensor, kmul: str,
              reps: int) -> torch.Tensor:
    """Kernel K7b (F a prime field, 8 chains) or K7d (F the Fq2 field, 4
    chains): per element, chains x <- mul(x, b) of `reps` products each
    by the Montgomery product kmul, started from F.add of the inputs as
    roofline.py:176 does, then summed; a, b are canonical (*el, N)
    arrays."""
    check_kmul(kmul)
    _check_pair(a, b, F.el_shape)
    k7 = "K7b" if F.el_ndim == 1 else "K7d"
    if not kernel_device(a, F.n32, k7):
        return mul_chain_plain(F, a, b, kmul, reps)
    if F.n32 != 8:
        raise NotImplementedError(f"{k7} is built for 8 limbs (alt_bn128)")
    if F.el_ndim == 2:
        check_nr(F, "K7d")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    entry = "mul_chain" if F.el_ndim == 1 else "fq2_mul_chain"
    fn = _build.function("roofline", entry, _CHAIN_ARGS)
    Fp = F.prime_field
    name = f"{k7} {kmul}"
    _build.launch(fn, name, a.device, KMULS.index(kmul), _build.ptr(out),
                  _build.ptr(a), _build.ptr(b), a.shape[-1], reps, Fp.n32,
                  Fp.p_c, Fp.inv32, a.get_device(), _build.stream_ptr(a))
    _build.LAUNCHES[name] += 1
    return out


def mul_chain_plain(F, a: torch.Tensor, b: torch.Tensor, kmul: str,
                    reps: int) -> torch.Tensor:
    """The plain version of K7b and K7d on any device: the same chains on
    the plain field over kmul's product, the chains stacked on a trailing
    axis."""
    check_kmul(kmul)
    _check_pair(a, b, F.el_shape)
    P = F.plain.with_kmul(kmul)
    ax = F.el_ndim - 1                                 # the limb axis
    x, y = to16(a, ax), to16(b, ax)
    chains = CHAINS[F.el_ndim]
    rest = P.add(x, P.add(y, x))
    xs = torch.stack([P.add(x, y)] + [rest] * (chains - 1), dim=-1)
    for _ in range(reps):
        xs = P.mul(xs, y.unsqueeze(-1))
    acc = xs[..., 0]
    for k in range(1, chains):
        acc = P.add(acc, xs[..., k])
    return to32(acc, ax)


def lone_name(n32: int, product: str = "cios") -> str:
    """K7b lone's launch count for `product` at n32 limbs: "K7b lone",
    "K7b lone n12", "K7b lone eo n12", "K7b lone n24"."""
    return _build.width_name(_build.kmul_name("K7b lone", product), n32)


def lone_chain(F, a: torch.Tensor, b: torch.Tensor, reps: int,
               product: str = "cios") -> torch.Tensor:
    """Kernel K7b lone (F a prime field): per element one serial chain x
    <- mul(x, b) of `reps` products from x = a; a, b canonical (n32, N)
    arrays.  `product`: "cios" (fp.cuh's, 8, 12 and 24 limbs, each width
    its own source: roofline.cu, roofline_n12.cu, roofline_n24.cu) or
    "eo" (chain_mul.cuh's two-accumulator product, 12 limbs: the Horner
    scan's at 12 limbs); both give the canonical residue."""
    _check_pair(a, b, F.el_shape)
    if product not in LONE_PRODUCTS.get(F.n32, ()):
        raise ValueError(f"K7b lone has no {product!r} product at {F.n32} "
                         f"limbs; {LONE_PRODUCTS}")
    if not kernel_device(a, F.n32, "K7b lone"):
        return lone_chain_plain(F, a, b, reps)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    name = lone_name(F.n32, product)
    args = (_build.ptr(out), _build.ptr(a), _build.ptr(b), a.shape[-1], reps,
            F.n32, F.p_c, F.inv32, a.get_device(), _build.stream_ptr(a))
    if F.n32 == 8:
        fn = _build.function("roofline", "mul_lone_chain", _LONE_ARGS)
    else:
        fn = _build.function(_build.width_stem("roofline", F.n32),
                             f"mul_lone_chain_n{F.n32}", _CHAIN_ARGS)
        args = (LONE_PRODUCTS[F.n32].index(product),) + args
    _build.launch(fn, name, a.device, *args)
    _build.LAUNCHES[name] += 1
    return out


def lone_chain_plain(F, a: torch.Tensor, b: torch.Tensor,
                     reps: int) -> torch.Tensor:
    """The plain version of K7b lone on any device (every product gives
    the canonical residue, so one plain version serves all)."""
    _check_pair(a, b, F.el_shape)
    x, y = to16(a), to16(b)
    for _ in range(reps):
        x = F.plain.mul(x, y)
    return to32(x)


def mul_eo_words(a: list[int], b: list[int], p: int, inv: int) -> list[int]:
    """chain_mul.cuh's mul_eo as its 32-bit words go, on lists of n (even)
    little-endian words: the two accumulators, the role swap, the merge
    and the final subtraction; raises where a carry that the kernel drops
    is not zero or the merged value is not below 2p.  The CPU tests hold
    it against the CIOS product."""
    n, M = len(a), MASK32
    pw = [(p >> (32 * j)) & M for j in range(n)]

    def chain(acc, xs, m, at=0):
        """acc[at + 2k], acc[at + 2k + 1] += lo, hi of xs[k] m, one carry
        chain; returns its carry out"""
        c = 0
        for k, x in enumerate(xs):
            for w, part in ((at + 2 * k, x * m & M), (at + 2 * k + 1,
                                                      x * m >> 32)):
                s = acc[w] + part + c
                acc[w], c = s & M, s >> 32
        return c

    def need(cond, what):
        if not cond:
            raise ArithmeticError(f"mul_eo: {what}")

    ev, od = [0] * n, [0] * n
    for i in range(n):
        E, O = (ev, od) if i % 2 == 0 else (od, ev)
        bi = b[i]
        if i == 0:
            chain(O, a[1::2], bi)
            chain(E, a[0::2], bi)
        else:
            s = E[0] + O[1]
            E[0], c = s & M, s >> 32
            shifted = O[2:] + [0, 0]
            for k, x in enumerate(a[1::2]):
                for w, part in ((2 * k, x * bi & M),
                                (2 * k + 1, x * bi >> 32)):
                    s = shifted[w] + part + c
                    shifted[w], c = s & M, s >> 32
            need(c == 0, "the odd row's carry")
            O[:] = shifted
            O[n - 1] += chain(E, a[0::2], bi)
            need(O[n - 1] <= M, "the even row's carry")
        m = E[0] * inv & M
        need(chain(O, pw[1::2], m) == 0, "the quotient's odd carry")
        O[n - 1] += chain(E, pw[0::2], m)
        need(O[n - 1] <= M and E[0] == 0, "the quotient's even row")
    v = sum(w << (32 * i) for i, w in enumerate(ev)) + sum(
        w << (32 * (i - 1)) for i, w in enumerate(od) if i)
    need(v < 2 * p, "the merged value is 2p or more")
    v = v - p if v >= p else v
    return [(v >> (32 * j)) & M for j in range(n)]


# -- timing on the card -------------------------------------------------------

def random_words(shape, rng, dev) -> torch.Tensor:
    """Uniform 32-bit words as an int32 tensor on dev."""
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


def sol_inputs(rng, dev):
    """K7a's inputs at the JAX shape: two (8, SOL_N) random word arrays."""
    return tuple(random_words((8, SOL_N), rng, dev) for _ in range(2))


def sol_mul_ns(a: torch.Tensor, b: torch.Tensor):
    """K7a's ns per synthetic product on a, b (SOL_REPS products an
    element), and the output of the timed calls."""
    ms, out = timed_output(lambda: sol_mix(a, b, SOL_REPS), 10)
    return ms * 1e6 / (a.shape[-1] * SOL_REPS), out


def chain_shape(F) -> tuple[int, int]:
    """(elements, rounds) of K7b (F prime) or K7d (F Fq2) at the JAX
    shape."""
    return (CHAIN_N, CHAIN_REPS) if F.el_ndim == 1 else (FQ2_N, FQ2_REPS)


def chain_mul_ns(F, kmul: str, a: torch.Tensor, b: torch.Tensor):
    """K7b's (F prime) or K7d's (F Fq2) ns per product on the canonical
    arrays a, b, at the JAX shape's rounds, and the output of the timed
    calls."""
    reps = chain_shape(F)[1]
    ms, out = timed_output(lambda: mul_chain(F, a, b, kmul, reps), 5)
    return ms * 1e6 / (a.shape[-1] * reps * CHAINS[F.el_ndim]), out


def k1e_mul_ns(F, n: int, rng, dev) -> float:
    """ns per product of 8 chained F.mul calls, each a K1e launch."""
    a, b = (workload.rand_elements(F, n, rng, dev) for _ in range(2))

    def chain():
        x = a
        for _ in range(8):
            x = F.mul(x, b)
        return x

    return event_ms(chain, 10) * 1e6 / (8 * n)


def lone_product_ns(F, a: torch.Tensor, b: torch.Tensor,
                    reps: int = LONE_REPS, product: str = "cios"):
    """K7b lone's ns per product on the one-element arrays a, b: the time
    at reps products less the time at reps / 2, over reps / 2.  Returns
    (ns, {reps: ms}, {reps: output of the timed calls})."""
    ms, outs = {}, {}
    for r in (reps, reps // 2):
        ms[r], outs[r] = timed_output(
            lambda: lone_chain(F, a, b, r, product), 20)
    return (ms[reps] - ms[reps // 2]) * 1e6 / (reps // 2), ms, outs


def insert_mul_ns(dc, log2n: int, dev) -> tuple[float, int]:
    """ns per product of one K2 G1 pass under the default configuration
    at 2^log2n points: its time over its mixed adds times 11 products (the
    adds, the bucket traffic and the skipped digits all count as product
    time, as roofline.py:207-242 counts them).  Returns (ns, madds)."""
    G = dc.g1
    scalars, points, _ = workload.msm_case(dc, "g1", log2n, dev)
    cfg = default_config(1 << log2n, G, dev)
    W = dig.num_signed_digits(G.order, workload.scalar_bits(G), cfg.c)
    s, pts, T, L = _prepare(G, scalars, points, cfg)
    d = dig.signed_digits(s, cfg.c, W).reshape(W, T, L)
    B = 1 << (cfg.c - 1)
    madds = int(((d != 0) & ~pts[3][None]).sum())
    ms = event_ms(lambda: insert(G, d, pts, B), 3)
    return ms * 1e6 / (madds * MADDS_MULS), madds


def multiplies(ops) -> dict:
    """The multiply-adds among SASS opcodes, by kind: "lo" (IMAD,
    IMAD.U32), "hi" (IMAD.HI), "wide" (IMAD.WIDE, both halves at once),
    and "carry_adds", the IADD3.X that carry a chain.  IMAD.X, .MOV,
    .SHL and .IADD are adds, moves and shifts that ptxas puts on the
    multiply pipe, and are left out."""
    kinds = {"lo": ("IMAD", "IMAD.U32"), "hi": ("IMAD.HI", "IMAD.HI.U32"),
             "wide": ("IMAD.WIDE", "IMAD.WIDE.U32"),
             "carry_adds": ("IADD3.X",)}
    return {k: sum(ops.get(op, 0) for op in names)
            for k, names in kinds.items()}


def sass_report() -> dict | None:
    """What the card runs for a product, from the SASS (None without
    cuobjdump): K1e's fp_mul less its fp_add kernel, one CIOS product on
    identical addressing; each K7b and K7d kernel's counts over the base
    products of its loop body (8 and 12; a few address IMADs outside the
    loop included); K7a's per synthetic product."""
    fp_ops, roof = (_build.sass_opcodes(s) for s in ("fp_ops", "roofline"))
    if fp_ops is None:
        return None

    def find(table, pattern):
        (name,) = [f for f in table if re.search(pattern, f)]
        return multiplies(table[name])

    mul, add = (find(fp_ops, rf"fp_elementwiseILi{op}E") for op in (2, 0))
    out = {"K1e cios product": {k: mul[k] - add[k] for k in mul}}
    for kern, k7, per in (("chain_kernel", "K7b", 8),
                          ("chain2_kernel", "K7d", 12)):
        for i, k in enumerate(KMULS):
            c = find(roof, rf"\d{kern}ILN3lff3MulE{i}E")
            out[f"{k7} {k} per base product"] = {n: v / per
                                                 for n, v in c.items()}
    out["K7a per synthetic product"] = find(roof, r"sol_kernel")
    return out


def ratios(roofline_ns: float, product_ns: dict,
           insert_ns: float | None) -> dict:
    """roofline.py:307-338: `ratio` is the best per-product time, the
    insert's included, over the no-stall bound, `production_ratio` the
    insert's per-product time over the same bound; `ok` is the ratio
    against the 1.3 target."""
    best = min(v for v in (*product_ns.values(), insert_ns) if v is not None)
    ratio = best / roofline_ns
    return {"ratio": ratio,
            "production_ratio": (insert_ns / roofline_ns
                                 if insert_ns is not None else None),
            "target": TARGET, "ok": ratio <= TARGET}


def measure(log2n: int = 20, impls: tuple = KMULS) -> dict:
    """Every number of the module docstring, on the first card."""
    for k in impls:
        check_kmul(k)
    dev = torch.device("cuda", 0)
    dc = device_curve("alt_bn128")
    rng = np.random.default_rng(0)
    _build.build()
    a, b = sol_inputs(rng, dev)
    mhz = clock_under_load(lambda: sol_mix(a, b, SOL_REPS))
    roof = sol_mul_ns(a, b)[0]
    del a, b
    out = {"platform": "gpu", "device": torch.cuda.get_device_name(0),
           "card": _build.card_name_power(), "sm_clock_mhz": mhz,
           "limbs": dc.fq.n32, "elements": 1 << log2n,
           "field_mul_k1e_ns": k1e_mul_ns(dc.fq, 1 << log2n, rng, dev),
           "lone_product_ns": lone_product_ns(
               dc.fq, *(workload.rand_elements(dc.fq, 1, rng, dev)
                        for _ in range(2)))[0]}
    products = {"k1e": out["field_mul_k1e_ns"]}
    for F, key in ((dc.fq, "field_mul"), (dc.fq2, "fq2_mul")):
        n = chain_shape(F)[0]
        a, b = (workload.rand_elements(F, n, rng, dev) for _ in range(2))
        for k in KMULS:
            v = chain_mul_ns(F, k, a, b)[0] if k in impls else None
            out[f"{key}_{k}_ns"] = v
            if F.el_ndim == 1:
                products[k] = v
        del a, b
    ins, madds = insert_mul_ns(dc, min(log2n, 18), dev)
    out.update({"field_mul_insert_kernel_ns": ins, "insert_madds": madds,
                "roofline_ns": roof, **ratios(roof, products, ins),
                "sass": sass_report()})
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("roofline: needs a CUDA card", file=sys.stderr)
        return 2
    log2n = int(argv[0]) if argv else 20
    impls = tuple(argv[1].split(",")) if len(argv) > 1 else KMULS
    print(json.dumps(measure(log2n, impls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
