"""Kernel K2's plain version against the JAX package's Pallas insert.

The port's ``insert`` on CPU tensors runs its plain version: a loop over t
with gather/scatter on the bucket axis.  The raw projective buckets must
equal those of the JAX kernel ``insert_pallas3`` (packed, merge=False, its
body run through ``interpret="reference"``) bit for bit, because insert
order and formula are the same.  The context is the toy G1 curve of
tests/test_pallas_interpret.py: c = 4, L = 128, 256 points, one zero
scalar and one point at infinity.

The card's K2 is a sort then a walk of bucket chains: its plain versions
``bucket_lists_plain`` and ``insert_from_lists_plain`` must list every
step once, stably, and give ``insert_plain``'s buckets bit for bit, and
the sort kernel's scheme (``bucket_lists_by_groups``: passes of buckets,
ranks within groups of steps) must give ``bucket_lists_plain``'s lists,
on the toy G1 curve and its Fq2 twin, with lanes that put every step in
one bucket, lanes of zero digits and lanes at infinity.
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
from libff_tpu_torch import _build, convert, tune_insert
from libff_tpu_torch.curves.group import AffinePoint, Group
from libff_tpu_torch.fields.fp import PrimeField
from libff_tpu_torch.fields.tower import ExtField
from libff_tpu_torch.msm import digits as tdig
from libff_tpu_torch.msm.insert import (SORT_BINS, bucket_lists_by_groups,
                                        bucket_lists_plain, insert,
                                        insert_from_lists_plain,
                                        insert_plain)
from libff_tpu_torch.msm.pippenger import MsmConfig, _prepare
from tests.test_pallas_interpret import (B_TOY, GEN_TOY, N_TOY, NR_TOY,
                                         NUM_BITS, P_TOY, _gdef)

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


# the lists' toy case: windows, steps, lanes, buckets; by lane l mod 8: 0
# every step in bucket (l // 8) % B, 1 zero digits, 2 every point at
# infinity, 3 the edge digit +-B, the others random
LISTS_SHAPE = (3, 7, 16, 8)


def _toy_group(group):
    Fh = hf.Fp(P_TOY, name="toy_Fp")
    Fp = PrimeField(P_TOY, name="toy_Fp")
    if group == "g1":
        E = hec.WeierstrassCurve(Fh, 0, B_TOY, name="toy_E")
        return Group(Fp, _gdef(E, GEN_TOY, N_TOY)), E, GEN_TOY
    F2h = hf.Ext(Fh, 2, NR_TOY, name="toy_Fp2")
    E2 = hec.WeierstrassCurve(F2h, F2h.zero(), (B_TOY, 0), name="toy_E2")
    for x0 in range(P_TOY):        # a point outside E(Fp), as g2ctx's
        rhs = F2h.add(F2h.mul(F2h.sqr((x0, 1)), (x0, 1)), (B_TOY, 0))
        if F2h.is_square(rhs):
            gen = ((x0, 1), F2h.sqrt(rhs))
            break
    return Group(ExtField(Fp, F2h), _gdef(E2, gen, N_TOY)), E2, gen


@pytest.fixture(scope="module", params=["g1", "g2"])
def lists_case(request):
    """(group, d, pts, B) on LISTS_SHAPE, from a numpy seed."""
    G, E, gen = _toy_group(request.param)
    W, T, L, B = LISTS_SHAPE
    rng = np.random.default_rng(17)
    d = rng.integers(-B, B + 1, (W, T, L)).astype(np.int32)
    lanes = np.arange(L)
    sign = np.where(rng.random((W, T, L)) < 0.5, -1, 1)
    d[:, :, lanes % 8 == 0] = (sign * ((lanes // 8) % B + 1))[:, :,
                                                              lanes % 8 == 0]
    d[:, :, lanes % 8 == 1] = 0
    d[:, :, lanes % 8 == 3] = (sign * B)[:, :, lanes % 8 == 3]
    pinf = rng.random((T, L)) < 0.1
    pinf[:, lanes % 8 == 2] = True
    pts = [E.mul(int(k), gen) for k in rng.integers(1, N_TOY, T * L)]
    F = G.F
    load = F.from_ints if F.el_ndim == 1 else F.from_host_batch
    x, y = (load([p[i] for p in pts], "cpu").reshape(F.el_shape + (T, L))
            for i in (0, 1))
    return G, torch.from_numpy(d), (x, y, F.neg(y), torch.from_numpy(pinf)), B


def test_bucket_lists_plain_is_complete_and_stable(lists_case):
    """Every step with a non-zero digit and a finite point appears once,
    in its bucket's list, with its sign, t increasing within a bucket;
    the row ends in -1."""
    _, d, pts, B = lists_case
    off, ent = bucket_lists_plain(d, pts[3], B)
    W, T, L = d.shape
    assert off.shape == (W, L, B + 1) and off.dtype == torch.int32
    assert ent.shape == (W, L, T) and ent.dtype == torch.int16
    dl, pinf = d.tolist(), pts[3].tolist()
    for w in range(W):
        for l in range(L):
            o, e = off[w, l].tolist(), ent[w, l].tolist()
            want = [[] for _ in range(B)]
            for t in range(T):
                k = dl[w][t][l]
                if k and not pinf[t][l]:
                    want[min(abs(k), B) - 1].append(2 * t + (k < 0))
            assert o[0] == 0
            assert [e[o[b]:o[b + 1]] for b in range(B)] == want
            assert e[o[B]:] == [-1] * (T - o[B])
    # the lanes of zero digits and at infinity list nothing; lane 8 lists
    # every finite step in bucket 1
    assert off[:, 1:3, B].eq(0).all()
    n = T - int(pts[3][:, 8].sum())
    assert off[:, 8, 1:3].tolist() == [[0, n]] * W and n > 0


@pytest.mark.parametrize("group,bins,one_bucket", [
    (32, SORT_BINS, False), (4, 3, False), (3, 1, False), (4, 8, True)])
def test_bucket_lists_by_groups_matches_plain(lists_case, group, bins,
                                              one_bucket):
    """The sort kernel's scheme gives bucket_lists_plain's lists: one
    group and one pass as on the path; T = 7 steps in groups of 4 and of
    3 (the last group part-way) with passes of 3 buckets of B = 8 (the
    last pass part-way) and of 1; and B = 1."""
    _, d, pts, B = lists_case
    if one_bucket:
        d, B = d.clamp(-1, 1), 1
    got = bucket_lists_by_groups(d, pts[3], B, group, bins)
    for g, w in zip(got, bucket_lists_plain(d, pts[3], B)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("entries", [1, 3, 8])
def test_insert_from_lists_matches_insert_plain(lists_case, entries):
    """The chain walk over the lists, ceil(T / entries) threads a lane (7,
    3 and 1 for T = 7: a share of 3 entries does not divide T), gives
    insert_plain's raw buckets bit for bit."""
    G, d, pts, B = lists_case
    want = insert_plain(G, d, pts, B)
    got = insert_from_lists_plain(G, bucket_lists_plain(d, pts[3], B), pts,
                                  B, entries)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", tune_insert.TUNABLES)
def test_tune_insert_macros_are_open_in_the_header(name):
    """Each macro tune_insert sets by -D is one that insert.cuh defines
    only when it is not set, and gives a default there."""
    head = (_build.CSRC / "insert.cuh").read_text()
    assert f"#ifndef {name}\n#define {name} " in head
    assert head.count(name) >= 3     # guarded, defaulted, used
