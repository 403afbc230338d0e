"""Kernel K2's plain version against the JAX package's Pallas insert.

The port's ``insert`` on CPU tensors runs its plain version: a loop over t
with gather/scatter on the bucket axis.  The raw projective buckets must
equal those of the JAX kernel ``insert_pallas3`` (packed, merge=False, its
body run through ``interpret="reference"``) bit for bit, because insert
order and formula are the same.  The context is the toy G1 curve of
tests/test_pallas_interpret.py: c = 4, L = 128, 256 points, one zero
scalar and one point at infinity.
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
from libff_tpu.msm.pallas_insert3 import insert_pallas3
from libff_tpu.msm.pippenger import MsmConfig as JaxMsmConfig
from libff_tpu.msm.pippenger import _prepare as jax_prepare
from libff_tpu_torch import convert
from libff_tpu_torch.curves.group import AffinePoint, Group
from libff_tpu_torch.fields.fp import PrimeField
from libff_tpu_torch.msm import digits as tdig
from libff_tpu_torch.msm.insert import insert, insert_plain
from libff_tpu_torch.msm.pippenger import MsmConfig, _prepare
from tests.test_pallas_interpret import (B_TOY, GEN_TOY, N_TOY, NUM_BITS,
                                         P_TOY, _gdef)

torch.set_num_threads(1)

C = 4
LANES = 128
NPTS = 256
ZERO_SCALAR = 2
INF_POINT = 5


@pytest.fixture(scope="module")
def ctx():
    """The same scalars and points, prepared by the JAX package and by the
    port: (E, port group, JAX (d, pts), port (d, pts), B, host inputs)."""
    Fh = hf.Fp(P_TOY, name="toy_Fp")
    E = hec.WeierstrassCurve(Fh, 0, B_TOY, name="toy_E")
    gdef = _gdef(E, GEN_TOY, N_TOY)
    JG = JaxGroup(JaxPrimeField(P_TOY, name="toy_Fp"), gdef)
    TG = Group(PrimeField(P_TOY, name="toy_Fp"), gdef)
    rng = np.random.default_rng(31)
    ks = [int(k) for k in rng.integers(0, 1 << NUM_BITS, size=NPTS)]
    ks[ZERO_SCALAR] = 0
    ks[7] = (1 << (C - 1))                  # digit 2^(c-1): bucket B-1
    pts = [E.mul(int(k), GEN_TOY)
           for k in rng.integers(1, N_TOY, size=NPTS)]
    inf = np.zeros(NPTS, dtype=bool)
    inf[INF_POINT] = True
    limbs = np.zeros((JG.F.n, NPTS), dtype=np.uint32)
    for i, k in enumerate(ks):
        limbs[0, i] = k
    W = jdig.num_signed_digits(N_TOY, NUM_BITS, C)
    B = 1 << (C - 1)
    jA = JaxAffine(JG.F.from_ints([p[0] for p in pts]),
                   JG.F.from_ints([p[1] for p in pts]), jnp.asarray(inf))
    s2, jpts, _, T, L = jax_prepare(JG, jnp.asarray(limbs), jA,
                                    JaxMsmConfig(c=C, lanes=LANES))
    jd = jdig.signed_digits(s2, C, W).reshape(W, T, L)
    tA = convert.affine_to_torch((np.asarray(jA.x), np.asarray(jA.y), inf),
                                 "cpu")
    t2, tpts, T2, L2 = _prepare(TG, convert.field_to_torch(limbs, "cpu"), tA,
                                MsmConfig(c=C, lanes=LANES))
    assert (T2, L2) == (T, L)
    td = tdig.signed_digits(t2, C, W).reshape(W, T, L)
    return E, JG, TG, (jd, jpts), (td, tpts), B, (ks, pts, inf)


def test_prepared_inputs_match_jax(ctx):
    _, _, _, (jd, jpts), (td, tpts), _, _ = ctx
    assert torch.equal(td, torch.from_numpy(np.array(jd)))
    for j, t in zip(jpts[:3], tpts[:3]):
        assert torch.equal(t, convert.field_to_torch(np.asarray(j), "cpu"))
    assert torch.equal(tpts[3], torch.from_numpy(np.array(jpts[3])))
    # the digit range's edge is present and maps to the last bucket
    assert int(td.abs().max()) == 1 << (C - 1)


def test_insert_plain_matches_pallas_kernel(ctx):
    _, JG, TG, (jd, jpts), (td, tpts), B, _ = ctx
    want = insert_pallas3(JG, jd, jpts, B, packed=True, merge=False,
                          interpret="reference")
    got = insert(TG, td, tpts, B)
    for g, w in zip(got, want):
        assert g.shape == (TG.F.n32,) + tuple(td.shape[:1]) + (B, LANES)
        assert torch.equal(g, convert.field_to_torch(np.asarray(w), "cpu"))


def test_insert_buckets_hold_host_sums(ctx):
    """Independent of the JAX kernel: bucket (w, b, l) is the host sum of
    +-P_(t*L + l) over the t whose digit is +-(b+1); zero digits and the
    point at infinity add nothing."""
    E, _, TG, _, (td, tpts), B, (_, pts, inf) = ctx
    F = TG.F
    buckets = insert_plain(TG, td, tpts, B)
    W, T, L = td.shape
    X, Y, Z = (F.to_ints(c) for c in buckets)
    d = td.tolist()
    want = [None] * (W * B * L)
    for w in range(W):
        for t in range(T):
            for l in range(L):
                k, i = d[w][t][l], t * L + l
                if k == 0 or inf[i]:
                    continue
                e = (w * B + abs(k) - 1) * L + l
                want[e] = E.add(want[e], pts[i] if k > 0 else E.neg(pts[i]))
    for e, ref in enumerate(want):
        if ref is None:
            assert (X[e], Y[e] != 0, Z[e]) == (0, True, 0)
        else:
            zi = pow(Z[e], -1, P_TOY)
            assert (X[e] * zi % P_TOY, Y[e] * zi % P_TOY) == ref


def test_empty_buckets_are_the_identity(ctx):
    """Buckets no digit reaches stay (0, 1, 0), as the TPU kernel's
    initialisation leaves them (pallas_insert3.py:91-97)."""
    _, _, TG, _, (td, tpts), B, _ = ctx
    zero = torch.zeros_like(td)
    bx, by, bz = insert_plain(TG, zero, tpts, B)
    F = TG.F
    assert set(F.to_ints(bx)) == {0} and set(F.to_ints(bz)) == {0}
    assert set(F.to_ints(by)) == {1}


@pytest.mark.parametrize("case", ["digits", "coords", "pinf", "buckets",
                                  "device"])
def test_k2_wrapper_rejects(ctx, case):
    _, _, TG, _, (td, tpts), B, _ = ctx
    px, py, pneg, pinf = tpts
    d = td
    if case == "digits":
        d = td.to(torch.int64)
    elif case == "coords":
        px = px[:, :1]
    elif case == "pinf":
        pinf = pinf.to(torch.int32)
    elif case == "buckets":
        B = 0
    else:
        d, px, py, pneg, pinf = (a.to("meta") for a in (td, *tpts))
    with pytest.raises((ValueError, TypeError)):
        insert(TG, d, (px, py, pneg, pinf), B)
