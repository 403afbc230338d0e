"""The in-kernel Montgomery products (``MsmConfig.kmul``) and the field-mul
benches K7a-K7d on the CPU, through their plain versions.

- ``PlainField``'s three products against the JAX package's
  ``PrimeField.mul_unrolled``/``mul_sos``/``mul_sos2`` (fp.py:241-375),
  run eagerly, on alt_bn128's Fq and Fr and on the toy field p = 65539 of
  tests/test_pallas_interpret.py, and against host integers;
- ``PlainField2`` over each product against ``_KernelField2(F2, kmul)``;
- K2's plain insert over each product against ``insert_pallas3(kmul=...,
  interpret="reference")``, eagerly, on the toy G1 context's first window;
- the MSM under each kmul (and with merge="kernel", so K5's plain version
  runs over it) on 2^8 toy G1 points against the default's Jacobian limbs
  and the host MSM; alt_bn128's 2^8 MSM takes about 10 s on this CPU,
  most of it Horner's sequential doublings, which kmul does not touch;
- the configuration checks;
- K7b's and K7d's plain chains against the same chains of the JAX
  package's multipliers (roofline.py:170-182, g2_phases.py:65-84) at 64
  elements, and against host integers;
- K7a's and K7c's plain bodies against a numpy uint32 rendition of the
  same op sequences.  The JAX K7 pallas_calls run only on a TPU (the
  Pallas interpreter stalls on this CPU), so nothing here compares with
  them.

Inputs come from numpy seeds; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libff_tpu.curves.device import device_curve as jax_device_curve
from libff_tpu.fields.fp import PrimeField as JaxPrimeField
from libff_tpu.fields.tower import ExtField as JaxExtField
from libff_tpu.host import field as hf
from libff_tpu.msm.pallas_insert import _KernelField2
from libff_tpu.msm.pallas_insert3 import insert_pallas3
from libff_tpu_torch import convert
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.fields.fp import KMULS, PlainField, PrimeField, to16, to32
from libff_tpu_torch.fields.tower import ExtField
from libff_tpu_torch.issue_rates import BODIES, issue_body, issue_body_plain
from libff_tpu_torch.msm.insert import insert, insert_plain
from libff_tpu_torch.msm.pippenger import MsmConfig, msm_pippenger
from libff_tpu_torch.roofline import CHAINS, mul_chain, sol_mix, sol_mix_plain
from tests.test_pallas_interpret import (NR_TOY, NUM_BITS, P_TOY,  # noqa: F401
                                         g1ctx)
from tests.test_torch_merge import _port_group, _toy_msm_inputs

torch.set_num_threads(1)

M32 = np.uint64(0xFFFFFFFF)


def _values(p: int, n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(40), "little") % p
            for _ in range(n - 3)]
    return [0, 1, p - 1] + rand


def _jax_mul(JF, kmul: str):
    return {"cios": JF.mul_unrolled, "sos": JF.mul_sos,
            "sos2": JF.mul_sos2}[kmul]


FIELDS = {"fq": lambda: jax_device_curve("alt_bn128").fq,
          "fr": lambda: jax_device_curve("alt_bn128").fr,
          "toy": lambda: JaxPrimeField(P_TOY, name="toy_Fp")}


@pytest.mark.parametrize("kmul", KMULS)
@pytest.mark.parametrize("field", list(FIELDS))
def test_plain_products_match_jax_and_host(field, kmul):
    JF = FIELDS[field]()
    TF = PrimeField(JF.p)
    va, vb = _values(JF.p, 8, 1), _values(JF.p, 8, 2)[::-1]
    ja, jb = JF.from_ints(va), JF.from_ints(vb)
    a, b = (convert.field_to_torch(np.asarray(x), "cpu") for x in (ja, jb))
    P = TF.plain.with_kmul(kmul)
    assert P.kmul == kmul and TF.plain.kmul == "cios"
    got = to32(P.mul(to16(a), to16(b)))
    want = convert.field_to_torch(np.asarray(_jax_mul(JF, kmul)(ja, jb)),
                                  "cpu")
    assert torch.equal(got, want)
    assert TF.to_ints(got) == [x * y % JF.p for x, y in zip(va, vb)]


def test_plain_field_refuses_unknown_product():
    with pytest.raises(ValueError):
        PlainField(P_TOY, kmul="karatsuba")


@pytest.fixture(scope="module", params=["alt_bn128", "toy"])
def fq2(request):
    """(JAX Fq2, port Fq2)."""
    if request.param == "alt_bn128":
        return (jax_device_curve("alt_bn128").fq2,
                device_curve("alt_bn128").fq2)
    H = hf.Ext(hf.Fp(P_TOY, name="toy_Fp"), 2, NR_TOY, name="toy_Fp2")
    return (JaxExtField(JaxPrimeField(P_TOY, name="toy_Fp"), H),
            ExtField(PrimeField(P_TOY, name="toy_Fp"), H))


def _fq2_values(p: int, seed: int) -> list[tuple]:
    v = _values(p, 16, seed)
    return list(zip(v[:8], v[8:][::-1]))


@pytest.mark.parametrize("kmul", KMULS)
def test_fq2_plain_matches_kernel_field2(fq2, kmul):
    JF, TF = fq2
    va, vb = _fq2_values(TF.B.p, 3), _fq2_values(TF.B.p, 4)
    ja, jb = JF.from_host_batch(va), JF.from_host_batch(vb)
    a, b = (to16(TF.from_host_batch(v, "cpu"), 1) for v in (va, vb))
    kf = _KernelField2(JF, kmul)
    P = TF.plain.with_kmul(kmul)
    for got, want in ((P.mul(a, b), kf.mul((ja[0], ja[1]), (jb[0], jb[1]))),
                      (P.sqr(a), kf.sqr((ja[0], ja[1])))):
        assert torch.equal(to32(got, 1), convert.field_to_torch(
            np.stack([np.asarray(w) for w in want]), "cpu", el_ndim=2))


# -- K2 and the MSM over each product ----------------------------------------

@pytest.fixture(scope="module")
def toy_window(g1ctx):  # noqa: F811
    """The toy G1 context's first window in both packages."""
    JG, _, d, pts, B, _ = g1ctx
    G = _port_group(JG)
    jd = d[:1]
    td = torch.from_numpy(np.array(jd))
    tpts = tuple(convert.field_to_torch(np.asarray(c), "cpu")
                 for c in pts[:3]) + (torch.from_numpy(np.array(pts[3])),)
    return JG, G, jd, pts, td, tpts, B


@pytest.mark.parametrize("kmul", ["sos", "sos2"])
def test_insert_plain_matches_pallas3_kmul(toy_window, kmul):
    JG, G, jd, jpts, td, tpts, B = toy_window
    want = insert_pallas3(JG, jd, jpts, B, kmul=kmul, interpret="reference")
    got = insert_plain(G, td, tpts, B, kmul)
    for g, w in zip(got, want):
        assert torch.equal(g, convert.field_to_torch(np.asarray(w), "cpu"))
    for g, w in zip(got, insert_plain(G, td, tpts, B)):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def toy_msm(toy_window):
    G = toy_window[1]
    s, A, want = _toy_msm_inputs(G, G.gdef.curve, G.gdef.generator, 256, 91)
    ref = msm_pippenger(G, s, A, NUM_BITS, config=MsmConfig(c=4, lanes=128))
    return G, s, A, want, ref


@pytest.mark.parametrize("kmul,merge", [("sos", False), ("sos2", False),
                                        ("sos2", "kernel")])
def test_msm_kmul_matches_default_and_host(toy_msm, kmul, merge):
    G, s, A, want, ref = toy_msm
    R = msm_pippenger(G, s, A, NUM_BITS, config=MsmConfig(
        c=4, lanes=128, merge=merge, kmul=kmul))
    for g, w in zip(R, ref):
        assert torch.equal(g, w)
    aff = G.to_affine(R)
    assert (G.F.to_host(aff.x), G.F.to_host(aff.y)) == want


@pytest.mark.parametrize("engine,kmul", [("auto", "karatsuba"),
                                         ("pallas3", "SOS"),
                                         ("pallas", "sos"),
                                         ("pallas", "sos2")])
def test_check_config_refuses_kmul(toy_msm, engine, kmul):
    G, s, A, _, _ = toy_msm
    with pytest.raises(ValueError):
        msm_pippenger(G, s, A, NUM_BITS, config=MsmConfig(
            c=4, lanes=128, engine=engine, kmul=kmul))


def test_insert_refuses_unknown_kmul(toy_window):
    _, G, _, _, td, tpts, B = toy_window
    with pytest.raises(ValueError):
        insert(G, td, tpts, B, kmul="cios2")


# -- K7b and K7d: chains of real products -----------------------------------

def _jax_chains(mul, add, a, b, chains: int, reps: int, stack, split):
    """roofline.py:173-182 and g2_phases.py:75-84, eagerly, the chains
    stacked on the batch axis so that each round is one JAX product."""
    xs = stack([add(a, add(b, a) if k else b) for k in range(chains)])
    bs = stack([b] * chains)
    for _ in range(reps):
        xs = mul(xs, bs)
    xs = split(xs, chains)
    acc = xs[0]
    for x in xs[1:]:
        acc = add(acc, x)
    return acc


def _cat(xs):
    return jnp.concatenate(xs, axis=-1)


def _split(x, k):
    return jnp.split(x, k, axis=-1)


@pytest.mark.parametrize("kmul", KMULS)
def test_k7b_plain_matches_jax_chains_and_host(kmul):
    JF = jax_device_curve("alt_bn128").fq
    F = device_curve("alt_bn128").fq
    va, vb = _values(F.p, 64, 5), _values(F.p, 64, 6)[::-1]
    ja, jb = JF.from_ints(va), JF.from_ints(vb)
    want = _jax_chains(_jax_mul(JF, kmul), JF.add, ja, jb, CHAINS[1], 2,
                       _cat, _split)
    a, b = F.from_ints(va, "cpu"), F.from_ints(vb, "cpu")
    got = mul_chain(F, a, b, kmul, 2)
    assert torch.equal(got, convert.field_to_torch(np.asarray(want), "cpu"))
    p = F.p
    host = [sum(v * y * y for v in [(x + y) % p] + [(2 * x + y) % p] *
                (CHAINS[1] - 1)) % p for x, y in zip(va, vb)]
    assert F.to_ints(got) == host


@pytest.mark.parametrize("kmul", KMULS)
def test_k7d_plain_matches_jax_chains_and_host(kmul):
    dc = device_curve("alt_bn128")
    JF, F2 = jax_device_curve("alt_bn128").fq2, dc.fq2
    va, vb = _fq2_values(F2.B.p, 7) * 8, _fq2_values(F2.B.p, 8)[::-1] * 8
    ja, jb = JF.from_host_batch(va), JF.from_host_batch(vb)
    kf = _KernelField2(JF, kmul)
    want = _jax_chains(
        kf.mul, kf.add, (ja[0], ja[1]), (jb[0], jb[1]), CHAINS[2], 2,
        lambda xs: tuple(_cat([x[i] for x in xs]) for i in (0, 1)),
        lambda x, k: list(zip(_split(x[0], k), _split(x[1], k))))
    a, b = F2.from_host_batch(va, "cpu"), F2.from_host_batch(vb, "cpu")
    got = mul_chain(F2, a, b, kmul, 2)
    assert torch.equal(got, convert.field_to_torch(
        np.stack([np.asarray(w) for w in want]), "cpu", el_ndim=2))
    H = dc.cd.fq2
    host = []
    for x, y in zip(va, vb):
        xs = [H.add(x, y)] + [H.add(x, H.add(y, x))] * (CHAINS[2] - 1)
        acc = H.zero()
        for v in xs:
            acc = H.add(acc, H.mul(H.mul(v, y), y))
        host.append(acc)
    assert F2.to_host_batch(got) == host


def test_k7_wrappers_check_operands():
    F = device_curve("alt_bn128").fq
    a = F.from_ints([1, 2], "cpu")
    with pytest.raises(ValueError):
        mul_chain(F, a, a, "sos3", 1)
    with pytest.raises(ValueError):
        mul_chain(F, a, a[:, :1], "sos", 1)
    with pytest.raises(ValueError):
        mul_chain(F, a.to("meta"), a.to("meta"), "sos", 1)
    with pytest.raises(ValueError):
        sol_mix(a[:4], a[:4], 1)
    with pytest.raises(ValueError):
        issue_body("div", a[0], a[0])


# -- K7a and K7c: the synthetic op sequences ---------------------------------

def _u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)


def _np_mul(x, y):
    """(lo, hi) of the 64-bit product of uint64 arrays of 32-bit values,
    by Python ints (numpy's uint64 product would wrap)."""
    full = np.frompyfunc(lambda u, v: int(u) * int(v), 2, 1)(x, y)
    lo = np.frompyfunc(lambda f: f & 0xFFFFFFFF, 1, 1)(full).astype(np.uint64)
    hi = np.frompyfunc(lambda f: f >> 32, 1, 1)(full).astype(np.uint64)
    return lo, hi


def _sol_numpy(x, y, reps):
    """roofline.cu's sol_kernel, element by element in uint64 numpy."""
    lo, hi, s = x.copy(), y.copy(), x[:6].copy()
    for _ in range(reps):
        for i in range(8):
            pl, ph = _np_mul(np.broadcast_to(x[i], y.shape), y)
            lo, hi = (lo + pl) & M32, (hi + ph) & M32
            m, _ = _np_mul(x[i], y[7 - i])
            pl, ph = _np_mul(np.broadcast_to(m, y.shape), y)
            lo, hi = (lo + pl) & M32, (hi + ph) & M32
            s = (s + lo[:6]) & M32
        d = (lo - hi) & M32
        d8 = (s[0] - s[1]) & M32
        lo = np.where(d8 == 0, d, lo)
    out = lo ^ hi
    out[:6] ^= s
    return out


def _torch_words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint32).view(np.int32))


def test_k7a_plain_matches_numpy():
    rng = np.random.default_rng(9)
    x, y = _u32(rng, (8, 16)), _u32(rng, (8, 16))
    y[:, 0] = x[:, 0]                       # lo == hi paths, d8 == 0 lanes
    got = sol_mix_plain(_torch_words(x), _torch_words(y), 3)
    assert torch.equal(got, _torch_words(_sol_numpy(x, y, 3)))


def _issue_numpy(name, a, b, R):
    """issue_rates.cu's bodies in uint64 numpy."""
    def chains(K, op):
        x = [(a + i) & M32 for i in range(K)]
        for _ in range(R // K):
            x = [op(v) for v in x]
        acc = x[0]
        for v in x[1:]:
            acc = acc ^ v
        return acc

    if name == "mul_lo":
        return chains(8, lambda v: _np_mul(v, b)[0])
    if name == "mul_hi":
        return chains(8, lambda v: _np_mul(v, b)[1])
    if name == "cheap":
        return chains(8, lambda v: (((v + b) & M32) & 0xFFFF) >> 1)
    if name.startswith("chain_"):
        return chains(int(name[6:]), lambda v: (_np_mul(v, b)[0] + a) & M32)
    if name == "mac":
        lo = [(a + k) & M32 for k in range(4)]
        hi = [(b + k) & M32 for k in range(4)]
        for _ in range(R // 4):
            for k in range(4):
                p = _np_mul(lo[k], b)[0]
                lo[k] = (lo[k] + (p & 0xFFFF)) & M32
                hi[k] = (hi[k] + (p >> 16)) & M32
        acc = lo[0] ^ hi[0]
        for k in range(1, 4):
            acc = acc ^ lo[k] ^ hi[k]
        return acc
    t = [(a + k) & M32 for k in range(10)]
    y = [(b + j) & M32 for j in range(8)]
    for _ in range(R // 16):
        c = 0
        for j in range(8):
            v = t[j] + _np_mul(a, y[j])[0] + c
            t[j], c = v & M32, v >> 32
        v = t[8] + c
        t[8], t[9] = v & M32, v >> 32
        c = 0
        for j in range(8):
            v = t[j + 1] + _np_mul(a, y[j])[1] + c
            t[j + 1], c = v & M32, v >> 32
        t[9] = (t[9] + c) & M32
    acc = t[0]
    for k in range(1, 10):
        acc = acc ^ t[k]
    return acc


@pytest.mark.parametrize("name", list(BODIES))
def test_k7c_plain_matches_numpy(name):
    rng = np.random.default_rng(10)
    a, b = _u32(rng, 8), _u32(rng, 8)
    a[0], b[0] = 0xFFFFFFFF, 0xFFFFFFFF
    got = issue_body_plain(name, _torch_words(a), _torch_words(b), 64)
    assert torch.equal(got, _torch_words(_issue_numpy(name, a, b, 64)))
    assert torch.equal(issue_body(name, _torch_words(a), _torch_words(b), 64),
                       got)
