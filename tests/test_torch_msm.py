"""The slice as a whole: the port's signed Pippenger MSM on the CPU.

``msm_pippenger`` on CPU tensors runs every kernel's plain version.  Its
affine result is held against the JAX package's ``msm_pippenger`` on the
toy curve of tests/test_pallas_interpret.py, and against the host oracle
(``E.msm``) and bench.py's structured oracle for alt_bn128 at 2^8 points.
The digit decomposition is held against the JAX package's.  All
comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libff_tpu.curves.group import AffinePoint as JaxAffine
from libff_tpu.curves.group import Group as JaxGroup
from libff_tpu.fields.fp import PrimeField as JaxPrimeField
from libff_tpu.host import ec as hec
from libff_tpu.host import field as hf
from libff_tpu.msm import digits as jdig
from libff_tpu.msm.pippenger import MsmConfig as JaxMsmConfig
from libff_tpu.msm.pippenger import msm_pippenger as jax_msm_pippenger
from libff_tpu_torch import convert, workload
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group import AffinePoint, Group
from libff_tpu_torch.fields.fp import PrimeField
from libff_tpu_torch.msm import digits as tdig
from libff_tpu_torch.msm.pippenger import (MsmConfig, default_config,
                                           msm_pippenger,
                                           msm_pippenger_windows)
from tests.test_pallas_interpret import B_TOY, GEN_TOY, N_TOY, P_TOY, _gdef

torch.set_num_threads(1)

TOY_BITS = N_TOY.bit_length()


@pytest.fixture(scope="module")
def toy():
    Fh = hf.Fp(P_TOY, name="toy_Fp")
    E = hec.WeierstrassCurve(Fh, 0, B_TOY, name="toy_E")
    gdef = _gdef(E, GEN_TOY, N_TOY)
    JG = JaxGroup(JaxPrimeField(P_TOY, name="toy_Fp"), gdef)
    TG = Group(PrimeField(P_TOY, name="toy_Fp"), gdef)
    return E, JG, TG


def _toy_inputs(E, n: int, seed: int, zero_scalars: bool = False):
    """Scalars < the order as (4, n) plain 16-bit limbs, points as host
    affine tuples (one at infinity), with the host MSM value."""
    rng = np.random.default_rng(seed)
    ks = [0] * n if zero_scalars else \
        [int(k) for k in rng.integers(0, N_TOY, size=n)]
    pts = [E.mul(int(k), GEN_TOY) for k in rng.integers(1, N_TOY, size=n)]
    inf = np.zeros(n, dtype=bool)
    inf[n // 3] = True
    limbs = np.zeros((4, n), dtype=np.uint32)
    limbs[0] = [k & 0xFFFF for k in ks]
    limbs[1] = [k >> 16 for k in ks]
    live = [p for p, i in zip(pts, inf) if not i]
    want = E.msm([k for k, i in zip(ks, inf) if not i], live)
    return limbs, pts, inf, want


def _port_msm(G, limbs, xs, ys, inf, cfg):
    """The port's MSM on CPU tensors -> host affine point (None = 0)."""
    A = AffinePoint(G.F.from_ints(xs, "cpu"), G.F.from_ints(ys, "cpu"),
                    torch.from_numpy(inf))
    R = msm_pippenger(G, convert.field_to_torch(limbs, "cpu"), A,
                      G.order.bit_length(), config=cfg)
    aff = G.to_affine(R)
    if bool(aff.inf):
        return None
    return (G.F.to_ints(aff.x)[0], G.F.to_ints(aff.y)[0])


def test_toy_msm_matches_jax(toy):
    E, JG, TG = toy
    limbs, pts, inf, want = _toy_inputs(E, 256, 41)
    xs, ys = [p[0] for p in pts], [p[1] for p in pts]
    jA = JaxAffine(JG.F.from_ints(xs), JG.F.from_ints(ys), jnp.asarray(inf))
    jR = jax_msm_pippenger(JG, jnp.asarray(limbs), jA, TOY_BITS,
                           config=JaxMsmConfig(c=4, lanes=32))
    jaff = JG.to_affine(jR)
    jgot = (JG.F.to_ints(jaff.x)[0], JG.F.to_ints(jaff.y)[0])
    got = _port_msm(TG, limbs, xs, ys, inf, MsmConfig(c=4, lanes=32))
    assert got == jgot == want


@pytest.mark.parametrize("n,c,lanes", [(200, 4, 32), (37, 3, 8), (64, 5, 64),
                                       (1, 4, 32)])
def test_toy_msm_shapes_match_host(toy, n, c, lanes):
    """Sizes that are no lane multiple (padding with points at infinity)
    and other window widths."""
    E, _, TG = toy
    limbs, pts, inf, want = _toy_inputs(E, n, 42 + n)
    got = _port_msm(TG, limbs, [p[0] for p in pts], [p[1] for p in pts],
                    inf, MsmConfig(c=c, lanes=lanes))
    assert got == want


def test_all_zero_scalars_give_infinity(toy):
    E, _, TG = toy
    limbs, pts, inf, want = _toy_inputs(E, 64, 43, zero_scalars=True)
    assert want is None
    got = _port_msm(TG, limbs, [p[0] for p in pts], [p[1] for p in pts],
                    inf, MsmConfig(c=4, lanes=32))
    assert got is None


def test_alt_bn128_2e8_matches_host_oracles():
    """The main path's curve and input structure (bench.py:72-137) at 2^8
    points: held against the structured oracle and the host E.msm."""
    dc = device_curve("alt_bn128")
    cd, G = dc.cd, dc.g1
    n = 1 << 8
    limbs, x, y = workload.msm_inputs(cd, n, 44)
    A = convert.affine_to_torch((x, y, np.zeros(n, dtype=bool)), "cpu")
    times = {}
    R = msm_pippenger(G, convert.field_to_torch(limbs, "cpu"), A, 254,
                      phase_times=times)
    assert set(times) == {"digits", "insert", "reduce", "horner", "finish"}
    aff = G.to_affine(R)
    got = (dc.fq.to_ints(aff.x)[0], dc.fq.to_ints(aff.y)[0])
    sums = workload.class_sums(limbs)
    assert got == workload.oracle(cd, sums)
    ks = [int.from_bytes(limbs[:, i].astype("<u2").tobytes(), "little")
          for i in range(n)]
    E, gen = cd.g1.curve, cd.g1.generator
    base = [E.mul(j + 1, gen) for j in range(32)]
    assert got == E.msm(ks, [base[i % 32] for i in range(n)])


def test_workload_inputs():
    """The MSM inputs: scalars below r with 0, 1 and r-1 first, points the
    32 generator multiples in Montgomery form, and exact class sums."""
    dc = device_curve("alt_bn128")
    cd = dc.cd
    limbs, x, y = workload.msm_inputs(cd, 64, 45)
    ks = [int.from_bytes(limbs[:, i].astype("<u2").tobytes(), "little")
          for i in range(64)]
    assert ks[:3] == [0, 1, cd.r - 1] and max(ks) < cd.r
    gen3 = cd.g1.curve.mul(3, cd.g1.generator)
    assert dc.fq.to_ints(convert.field_to_torch(x[:, 34:35], "cpu")) \
        == [gen3[0]]
    assert dc.fq.to_ints(convert.field_to_torch(y[:, 2:3], "cpu")) == [gen3[1]]
    sums = workload.class_sums(limbs)
    assert sums[5] == ks[5] + ks[37]


# -- digits ---------------------------------------------------------------

@pytest.mark.parametrize("c", [2, 3, 4, 5, 6, 7, 8, 9, 11, 13, 16])
def test_signed_digits_match_jax(c):
    dc = device_curve("alt_bn128")
    r = dc.cd.r
    rng = np.random.default_rng(46 + c)
    limbs = rng.integers(0, 1 << 16, size=(16, 32), dtype=np.uint32)
    limbs[15] = rng.integers(0, r >> 240, size=32, dtype=np.uint32)
    limbs[:, 0] = 0
    limbs[:, 1] = [(r - 1) >> (16 * i) & 0xFFFF for i in range(16)]
    W = tdig.num_signed_digits(r, 254, c)
    assert W == jdig.num_signed_digits(r, 254, c)
    got = tdig.signed_digits(convert.field_to_torch(limbs, "cpu"), c, W)
    assert torch.equal(got, torch.from_numpy(np.array(
        jdig.signed_digits(jnp.asarray(limbs), c, W))))
    assert int(got.abs().max()) <= 1 << (c - 1)
    assert torch.equal(
        tdig.get_digit(convert.field_to_torch(limbs, "cpu"), c, W - 2),
        torch.from_numpy(np.array(jdig.get_digit(jnp.asarray(limbs), c,
                                                 W - 2)).astype(np.int32)))
    un = tdig.unsigned_digits(convert.field_to_torch(limbs, "cpu"), c, W)
    assert torch.equal(un, torch.from_numpy(np.array(
        jdig.unsigned_digits(jnp.asarray(limbs), c, W))))
    # the digits sum back to the scalars
    vals = [int.from_bytes(limbs[:, i].astype("<u2").tobytes(), "little")
            for i in range(32)]
    dl = got.tolist()
    assert [sum(dl[w][i] << (c * w) for w in range(W))
            for i in range(32)] == vals


# -- what this slice leaves out raises ------------------------------------

def test_later_slices_raise(toy):
    E, _, TG = toy
    limbs, pts, inf, _ = _toy_inputs(E, 8, 47)
    A = AffinePoint(TG.F.from_ints([p[0] for p in pts], "cpu"),
                    TG.F.from_ints([p[1] for p in pts], "cpu"),
                    torch.from_numpy(inf))
    with pytest.raises(NotImplementedError):
        msm_pippenger(TG, convert.field_to_torch(limbs, "cpu"), A, TOY_BITS,
                      signed=False)
    with pytest.raises(NotImplementedError):
        msm_pippenger_windows(TG, convert.field_to_torch(limbs, "cpu"), A,
                              TOY_BITS, 0, 2)
    with pytest.raises(NotImplementedError):
        device_curve("mnt4")
    with pytest.raises(ValueError):
        msm_pippenger(TG, convert.field_to_torch(limbs, "cpu"), A, TOY_BITS,
                      config=MsmConfig(c=4, lanes=3))


def test_default_config():
    for n in (1, 64, 1 << 12, 1 << 20):
        for dev in ("cpu", "cuda"):
            cfg = default_config(n, device=dev)
            assert 2 <= cfg.c <= 16 and cfg.lanes & (cfg.lanes - 1) == 0
    assert default_config(1 << 20, device="cuda") == MsmConfig(c=8,
                                                                lanes=1024)
