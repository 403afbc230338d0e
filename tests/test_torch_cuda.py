"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and ``nvcc``; without them it skips.
The kernels have no CPU mode, so these tests are the kernels' own
pytest-level check (``chip_smoke.py`` checks them at the main path's
shapes).  On a machine with a card, from the repository root:

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: that machine has no jax, which tests/conftest.py
imports.)  Comparisons are exact.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from libff_tpu_torch import _build, workload
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group_ops import (
    OPS, group_op, group_op_pair_plain, group_op_plain, horner_scan,
    horner_scan_plain)
from libff_tpu_torch.curves.group import JacobianPoint, ProjectivePoint
from libff_tpu_torch.fields.fp import (PrimeField, fp_inv_plain, fp_op,
                                       fp_op_plain, to16, to32)
from libff_tpu_torch.fields.tower import (ExtField, fq2_inv_plain, fq2_op,
                                          fq2_op_plain)
from libff_tpu_torch.host import field as hf
from libff_tpu_torch.msm.insert import (bucket_lists, bucket_lists_plain,
                                       insert, insert_plain, insert_v1)
from libff_tpu_torch.msm.merge import merge_lanes, merge_lanes_plain
from libff_tpu_torch.msm.pippenger import MsmConfig, default_config
from libff_tpu_torch import (affine_experiment, issue_rates, roofline,
                             tune_insert)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    _build.build()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def dc():
    return device_curve("alt_bn128")


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_k1e_matches_plain(dev, dc, op):
    F = dc.fq
    rng = np.random.default_rng(1)
    a = chip_smoke.rand_elements(F, 4099, rng, dev)
    b = chip_smoke.rand_elements(F, 4099, rng, dev)
    edges = [0, 1, F.p - 1, F.p - 2, F.mp.R % F.p]
    a[:, :5], b[:, 5:10] = F.plain_from_ints(edges, dev), \
        F.plain_from_ints(edges, dev)
    before = _build.LAUNCHES["K1e"]
    got = fp_op(F, op, a, b)
    assert _build.LAUNCHES["K1e"] == before + 1
    assert torch.equal(got, fp_op_plain(F, op, a, b))


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_k4e_matches_plain(dev, dc, op):
    F2 = dc.fq2
    rng = np.random.default_rng(5)
    a = chip_smoke.rand_elements(F2, 4099, rng, dev)
    b = chip_smoke.rand_elements(F2, 4099, rng, dev)
    edges = [0, 1, F2.B.p - 1, F2.B.p - 2, F2.B.mp.R % F2.B.p]
    a[1, :, :5] = F2.B.plain_from_ints(edges, dev)
    b[0, :, 5:10] = F2.B.plain_from_ints(edges, dev)
    before = _build.LAUNCHES["K4e"]
    got = fq2_op(F2, op, a, b)
    assert _build.LAUNCHES["K4e"] == before + 1
    assert torch.equal(got, fq2_op_plain(F2, op, a, b))


@pytest.mark.parametrize("op", ["add", "sub", "neg"])
def test_k1e_fq2_matches_plain(dev, dc, op):
    """K1e's Fq2 branch: add, sub and neg act on both coefficients of a
    (2, n32, N) array in one launch, as _prepare's negation of y does."""
    F2 = dc.fq2
    rng = np.random.default_rng(6)
    a = chip_smoke.rand_elements(F2, 4099, rng, dev)
    b = chip_smoke.rand_elements(F2, 4099, rng, dev)
    edges = [0, 1, F2.B.p - 1, F2.B.p - 2, F2.B.mp.R % F2.B.p]
    a[1, :, :5] = F2.B.plain_from_ints(edges, dev)
    b[0, :, 5:10] = F2.B.plain_from_ints(edges, dev)
    if op == "neg":
        op, a = "sub", torch.zeros_like(a)
    before = _build.LAUNCHES["K1e"]
    got = getattr(F2, op)(a, b)
    assert _build.LAUNCHES["K1e"] == before + 1
    assert torch.equal(got, fq2_op_plain(F2, op, a, b))


def test_k4e_refuses_another_non_residue(dev, dc):
    """K4 is built for nr = p - 1 at 8 limbs (and p - 1, p - 5 at 12); an
    Fq2 with another non-residue runs only on the plain version and is
    refused on the card."""
    F2 = ExtField(dc.fq, hf.Ext(dc.cd.fq, 2, 2))
    a = F2.from_host_batch([(1, 2), (3, 4)], dev)
    with pytest.raises(NotImplementedError):
        fq2_op(F2, "mul", a, a)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_k3_matches_plain(dev, dc, op, group):
    G = getattr(dc, group)
    rng = np.random.default_rng(2)
    c, cm, q_inf = chip_smoke.k3_inputs(G.F, 3000, rng, dev)
    coords, masks = {"padd": (c, ()), "add": (c, ()), "pdbl": (c[:3], ()),
                     "dbl": (c[:3], ()), "pmadd": (list(cm), (q_inf,)),
                     "madd": (list(cm), (q_inf,))}[op]
    before = _build.LAUNCHES[f"K3 {group}"]
    got = group_op(G, op, coords, masks)
    assert _build.LAUNCHES[f"K3 {group}"] == before + 1
    for g, w in zip(got, group_op_plain(G, op, coords, masks)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [4099, 1 << 21])
@pytest.mark.parametrize("op", sorted(OPS))
def test_k3_g2_pairs_match_plain(dev, dc, op, n):
    """The G2 branch runs two threads an element: an odd N leaves the last
    block ragged (its pairs must leave together), and 2^21 is the G2
    path's first lane-halving padd.  The CPU emulation of the pair
    schedule (group_op_pair_plain) gives the same bits here too."""
    G = dc.g2
    c, cm, q_inf = chip_smoke.k3_inputs(G.F, n, np.random.default_rng(9),
                                        dev)
    coords, masks = {"padd": (c, ()), "add": (c, ()), "pdbl": (c[:3], ()),
                     "dbl": (c[:3], ()), "pmadd": (list(cm), (q_inf,)),
                     "madd": (list(cm), (q_inf,))}[op]
    got = group_op(G, op, coords, masks)
    for g, w in zip(got, group_op_plain(G, op, coords, masks)):
        assert torch.equal(g, w)
    if n < 1 << 21:
        for g, w in zip(got, group_op_pair_plain(G, op, coords, masks)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("W,c", [(32, 8), (5, 3), (2, 2), (1, 4)])
def test_k3_scan_matches_plain(dev, dc, group, W, c):
    """K3's scan entry in one launch against horner_scan_plain: the path's
    W = 32 totals at c = 8, and W = 5 (the tree pads to 8 with the
    identity), 2 and 1; the totals hold identities and repeated points."""
    G = getattr(dc, group)
    tot = chip_smoke.scan_inputs(G.F, W, np.random.default_rng(10 + W), dev)
    before = _build.LAUNCHES[f"K3 scan {group}"]
    got = horner_scan(G, tot, c)
    assert _build.LAUNCHES[f"K3 scan {group}"] == before + 1
    for g, w in zip(got, horner_scan_plain(G, tot, c)):
        assert g.shape == G.F.el_shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k2_matches_plain(dev, dc, group):
    # distinct points, some at infinity: the MSM workload's points repeat
    # with period 32 (16 on G2), which a kernel reading the wrong point
    # would not show
    G = getattr(dc, group)
    d, pts, B = chip_smoke.k2_inputs(dc, group, 1 << 12,
                                     MsmConfig(c=8, lanes=256),
                                     np.random.default_rng(3), dev)
    assert bool(pts[3].any())
    before = _build.LAUNCHES[f"K2 {group}"]
    got = insert(G, d, pts, B)
    assert _build.LAUNCHES[f"K2 {group}"] == before + 1
    for g, w in zip(got, insert_plain(G, d, pts, B)):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def k2_case(dev, dc):
    """Per group: distinct points (some at infinity) through the path's
    digits at c = 8, 256 lanes, with the plain raw buckets and their plain
    lane totals."""
    out = {}
    for group in ("g1", "g2"):
        G = getattr(dc, group)
        d, pts, B = chip_smoke.k2_inputs(dc, group, 1 << 12,
                                         MsmConfig(c=8, lanes=256),
                                         np.random.default_rng(7), dev)
        raw = insert_plain(G, d, pts, B)
        out[group] = (G, d, pts, B, raw, merge_lanes_plain(G, raw))
    return out


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k5_matches_plain(dev, k2_case, group):
    G, d, pts, B, raw, merged = k2_case[group]
    before = _build.LAUNCHES[f"K5 {group}"]
    got = merge_lanes(G, raw)
    assert _build.LAUNCHES[f"K5 {group}"] == before + 1
    for g, w in zip(got, merged):
        assert torch.equal(g, w)
    # lane counts the TPU kernel does not take, and the input left as it was
    for L in (1, 2, 32):
        part = type(raw)(*(a[..., :L].contiguous() for a in raw))
        copy = [a.clone() for a in part]
        for g, w in zip(merge_lanes(G, part), merge_lanes_plain(G, part)):
            assert torch.equal(g, w)
        assert all(torch.equal(a, c) for a, c in zip(part, copy))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k2m_matches_plain(dev, k2_case, group):
    G, d, pts, B, raw, merged = k2_case[group]
    before = _build.LAUNCHES[f"K2m {group}"]
    got = insert(G, d, pts, B, merge=True)
    assert _build.LAUNCHES[f"K2m {group}"] == before + 1
    for g, w in zip(got, merged):
        assert torch.equal(g, w)


MERGE_LANES = [1, 2, 4, 16, 32, 64, 128, 256, 1024, 2048]


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("L", MERGE_LANES)
def test_k5_matches_plain_at_every_lane_count(dev, dc, group, L):
    """K5 under each kmul against merge_lanes_plain at lane counts from 1
    to 2048 (the in-thread walk alone, the butterfly alone, both), on 3
    windows of 7 buckets: 21 rows, so the last block holds one; identity
    buckets and lanes at infinity among them (workload.merge_inputs)."""
    G = getattr(dc, group)
    raw = workload.merge_inputs(G, 3, 7, L, np.random.default_rng(L), dev)
    want = merge_lanes_plain(G, raw)
    for kmul in ("cios", "sos", "sos2"):
        name = _build.kmul_name(f"K5 {group}", kmul)
        before = _build.LAUNCHES[name]
        got = merge_lanes(G, raw, kmul)
        assert _build.LAUNCHES[name] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), kmul


# steps of each path's K2m checks: above insert.cuh's kEntries (512 on
# G1, 256 on G2), so the chain kernel runs 2 threads a lane
K2M_STEPS = {"g1": 520, "g2": 260}


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("L", [128, 256, 1024])
def test_k2m_matches_plain_with_two_chain_threads(dev, dc, group, L):
    """K2m under each kmul against insert_plain then merge_lanes_plain, on
    distinct points through the path's digits (c = 8, 32 windows) with
    windows 3 and 17 all zero digits, at W = 32 and at W = 1; counted once
    as K2m and never as K5; and twice in a row, each call equal."""
    G = getattr(dc, group)
    T = K2M_STEPS[group]
    d, pts, B = chip_smoke.k2_inputs(dc, group, T * L,
                                     MsmConfig(c=8, lanes=L),
                                     np.random.default_rng(L + 1), dev)
    assert d.shape == (32, T, L)
    d[3], d[17] = 0, 0
    want = merge_lanes_plain(G, insert_plain(G, d, pts, B))
    k5 = {k: v for k, v in _build.LAUNCHES.items() if k.startswith("K5")}
    for kmul in ("cios", "sos", "sos2"):
        name = _build.kmul_name(f"K2m {group}", kmul)
        for W in (32, 1):
            before = _build.LAUNCHES[name]
            got = insert(G, d[:W], pts, B, merge=True, kmul=kmul)
            assert _build.LAUNCHES[name] == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w[..., :W, :, :]), (kmul, W)
    assert k5 == {k: v for k, v in _build.LAUNCHES.items()
                  if k.startswith("K5")}
    first = insert(G, d, pts, B, merge=True)
    second = insert(G, d, pts, B, merge=True)
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, w) and torch.equal(b, w)


def test_k6_matches_plain(dev, k2_case):
    G, d, pts, B, raw, _ = k2_case["g1"]
    before = _build.LAUNCHES["K6 g1"]
    got = insert_v1(G, d, pts, B)
    assert _build.LAUNCHES["K6 g1"] == before + 1
    for g, w in zip(got, raw):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        insert_v1(k2_case["g2"][0], *k2_case["g2"][1:4])


@pytest.fixture(scope="module")
def skew_case(dev, dc):
    """Per group: distinct points through the path's digits at c = 8, 128
    lanes (T = 1024, so that the chain kernel runs 2 threads a lane on G1
    and 4 on G2), cut to 4 windows, with chip_smoke.skewed's lanes: one
    bucket takes a whole lane, zero digits, the last bucket, a lane at
    infinity."""
    out = {}
    for group in ("g1", "g2"):
        d, pts, B = chip_smoke.k2_inputs(dc, group, 1 << 17,
                                         MsmConfig(c=8, lanes=128),
                                         np.random.default_rng(5), dev)
        out[group] = (getattr(dc, group), *chip_smoke.skewed(d[:4], pts, B),
                      B)
    return out


SKEW_CUTS = ["skewed", "zero digits", "B=1", "T=1", "T=3", "T=600"]
# the plain insert's time grows with T, so the inserts' cases other than
# "skewed" (whose lane of one bucket needs T = 1024) run short: B = 1 at
# 600 steps (still 2 chain threads a lane on G1, 3 on G2), zero digits at
# 3 ("skewed" holds lanes of zero digits with several threads a lane)
INSERT_T = {"zero digits": 3, "B=1": 600}


# the sort's own cases: 40 lanes (a block's 32 and 8 of the next), B =
# 256 with digits up to +-255 (16-bit keys), T = 1100 (a lane longer
# than the sort's tile of 1024 steps, listed from device memory)
SORT_CUTS = SKEW_CUTS + ["L=40", "B=256", "T=1100"]


def _cut(case, cut, steps=None):
    G, d, pts, B = case
    if cut == "zero digits":
        d = torch.zeros_like(d)
    elif cut == "B=1":
        d, B = d.clamp(-1, 1), 1
    elif cut == "B=256":
        d, B = torch.where(d == 0, d, 2 * d - d.sign()), 256
    elif cut == "L=40":
        d = d[..., :40].contiguous()
        pts = tuple(a[..., :40].contiguous() for a in pts)
    elif cut == "T=1100":
        d = torch.cat([d, d[:, :76]], 1)
        pts = tuple(torch.cat([a, a[..., :76, :]], -2) for a in pts)
    elif cut.startswith("T="):
        steps = int(cut[2:])
    if steps is not None:
        d = d[:, :steps].contiguous()
        pts = tuple(a[..., :steps, :].contiguous() for a in pts)
    return G, d, pts, B


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("cut", SORT_CUTS)
def test_k2_sort_matches_plain(dev, skew_case, group, cut):
    G, d, pts, B = _cut(skew_case[group], cut)
    before = _build.LAUNCHES[f"K2 sort {group}"]
    got = bucket_lists(G, d, pts[3], B)
    assert _build.LAUNCHES[f"K2 sort {group}"] == before + 1
    for g, w in zip(got, bucket_lists_plain(d, pts[3], B)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("L,B", [(32, 16), (40, 300)])
def test_k2_sort_int32_entries_match_plain(dev, dc, L, B):
    """T > 16384 steps: the entries 2t + sign no longer fit int16; at B =
    300 with 16-bit keys in two passes of buckets, on 40 lanes."""
    rng = np.random.default_rng(12)
    W, T = 2, 16385
    d = torch.from_numpy(rng.integers(-B, B + 1, (W, T, L),
                                      dtype=np.int32)).to(dev)
    pinf = torch.from_numpy(rng.random((T, L)) < 0.05).to(dev)
    got = bucket_lists(dc.g1, d, pinf, B)
    assert got[1].dtype == torch.int32
    for g, w in zip(got, bucket_lists_plain(d, pinf, B)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("group,log2n", [("g1", 20), ("g2", 18)])
def test_k2_matches_plain_on_even_digits_at_path_shape(dev, dc, group,
                                                       log2n):
    """The MSM path's (W, T, L) with tune_insert's even digits, on
    distinct points: the sort at all W windows and K2 at 4 of them (its
    plain insert takes tens of seconds at all 32), against their plain
    versions."""
    G = getattr(dc, group)
    d, pts, B = chip_smoke.k2_inputs(dc, group, 1 << log2n,
                                     default_config(1 << log2n, dev),
                                     np.random.default_rng(9), dev)
    d = tune_insert.even_digits(d, B)
    for g, w in zip(bucket_lists(G, d, pts[3], B),
                    bucket_lists_plain(d, pts[3], B)):
        assert torch.equal(g, w)
    d = d[:4].contiguous()
    for g, w in zip(insert(G, d, pts, B), insert_plain(G, d, pts, B)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("cut", SKEW_CUTS)
def test_k2_k2m_k6_match_plain_on_skewed_digits(dev, skew_case, group, cut):
    """K2 under each kmul, K2m and (G1) K6 against insert_plain and
    merge_lanes_plain: chains of every length from 0 to T, zero digits,
    B = 1, T too short for one step per bucket, and T = 600, which the
    chain kernel's threads of a lane share unevenly."""
    G, d, pts, B = _cut(skew_case[group], cut, INSERT_T.get(cut))
    raw = insert_plain(G, d, pts, B)
    runs = [(_build.kmul_name(f"K2 {group}", k),
             lambda k=k: insert(G, d, pts, B, kmul=k), raw)
            for k in ("cios", "sos", "sos2")]
    runs.append((f"K2m {group}", lambda: insert(G, d, pts, B, merge=True),
                 merge_lanes_plain(G, raw)))
    if group == "g1":
        runs.append(("K6 g1", lambda: insert_v1(G, d, pts, B), raw))
    for name, fn, want in runs:
        before = _build.LAUNCHES[name]
        got = fn()
        assert _build.LAUNCHES[name] == before + 1, name
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


@pytest.mark.parametrize("group,fields,kernel", [
    ("g1", {"merge": "kernel"}, "K5 g1"), ("g1", {"merge": True}, "K2m g1"),
    ("g1", {"engine": "pallas"}, "K6 g1"),
    ("g2", {"merge": "kernel"}, "K5 g2"), ("g2", {"merge": True}, "K2m g2")])
def test_msm_configs_match_oracle(dev, dc, group, fields, kernel):
    s, A, want = workload.msm_case(dc, group, 12, dev, 8)
    _build.LAUNCHES.clear()
    got, _, _ = workload.run_msm(getattr(dc, group), s, A,
                                 MsmConfig(c=8, lanes=256, **fields))
    assert _build.LAUNCHES[kernel] == 1
    assert got == want


def test_msm_matches_oracle_and_keeps_current_device(dev, dc):
    s, A, want = workload.msm_case(dc, "g1", 12, dev, 4)
    current = torch.cuda.current_device()
    got, _, _ = workload.run_msm(dc.g1, s, A)
    assert torch.cuda.current_device() == current
    assert got == want


def test_g2_msm_matches_oracle(dev, dc):
    s, A, want = workload.msm_case(dc, "g2", 12, dev, 6)
    _build.LAUNCHES.clear()
    got, _, _ = workload.run_msm(dc.g2, s, A)
    assert all(_build.LAUNCHES[k] > 0
               for k in ("K1e", "K2 g2", "K3 g2", "K4e"))
    assert got == want


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("kmul", ["sos", "sos2"])
def test_kmul_branches_match_plain(dev, k2_case, group, kmul):
    """K2, K2m and K5 over each SOS product give the CIOS plain version's
    buckets: every product gives the canonical residue."""
    G, d, pts, B, raw, merged = k2_case[group]
    for name, fn, want in (
            (f"K2 {group} {kmul}", lambda: insert(G, d, pts, B, kmul=kmul),
             raw),
            (f"K2m {group} {kmul}",
             lambda: insert(G, d, pts, B, merge=True, kmul=kmul), merged),
            (f"K5 {group} {kmul}", lambda: merge_lanes(G, raw, kmul),
             merged)):
        before = _build.LAUNCHES[name]
        got = fn()
        assert _build.LAUNCHES[name] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("kmul", ["sos", "sos2"])
def test_msm_kmul_matches_oracle(dev, dc, group, kmul):
    s, A, want = workload.msm_case(dc, group, 12, dev, 9)
    _build.LAUNCHES.clear()
    got, _, _ = workload.run_msm(getattr(dc, group), s, A,
                                 MsmConfig(c=8, lanes=256, kmul=kmul))
    assert _build.LAUNCHES[f"K2 {group} {kmul}"] == 1
    assert got == want


def test_k7a_matches_plain(dev):
    rng = np.random.default_rng(11)
    a = roofline.random_words((8, 4099), rng, dev)
    b = roofline.random_words((8, 4099), rng, dev)
    b[:, :3] = a[:, :3]
    before = _build.LAUNCHES["K7a"]
    got = roofline.sol_mix(a, b, 3)
    assert _build.LAUNCHES["K7a"] == before + 1
    assert torch.equal(got, roofline.sol_mix_plain(a, b, 3))


@pytest.mark.parametrize("field", ["fq", "fq2"])
@pytest.mark.parametrize("kmul", ["cios", "sos", "sos2"])
def test_k7b_k7d_match_plain(dev, dc, field, kmul):
    F = getattr(dc, field)
    rng = np.random.default_rng(12)
    a = chip_smoke.rand_elements(F, 4099, rng, dev)
    b = chip_smoke.rand_elements(F, 4099, rng, dev)
    B = F.prime_field
    edges = [0, 1, B.p - 1, B.p - 2, B.mp.R % B.p]
    (a[0] if field == "fq2" else a)[:, :5] = B.plain_from_ints(edges, dev)
    (b[-1] if field == "fq2" else b)[:, 5:10] = B.plain_from_ints(edges, dev)
    name = f"{'K7b' if field == 'fq' else 'K7d'} {kmul}"
    before = _build.LAUNCHES[name]
    got = roofline.mul_chain(F, a, b, kmul, 2)
    assert _build.LAUNCHES[name] == before + 1
    assert torch.equal(got, roofline.mul_chain_plain(F, a, b, kmul, 2))


@pytest.mark.parametrize("curve,product", [("alt_bn128", "cios"),
                                           ("bls12_381", "cios"),
                                           ("bls12_381", "eo"),
                                           ("bls12_377", "eo"),
                                           ("bw6_761", "cios")])
def test_k7b_lone_matches_plain(dev, curve, product):
    """K7b lone at 8, 12 and 24 limbs, over CIOS and (at 12) the scan's
    two-accumulator product, the edge values first."""
    F = device_curve(curve).fq
    rng = np.random.default_rng(13)
    a, b = (chip_smoke.rand_elements(F, 300, rng, dev) for _ in range(2))
    edges = workload.edge_values(F)
    pairs = [(x, y) for x in edges for y in edges]
    a[:, :len(pairs)] = F.plain_from_ints([x for x, _ in pairs], dev)
    b[:, :len(pairs)] = F.plain_from_ints([y for _, y in pairs], dev)
    name = roofline.lone_name(F.n32, product)
    before = _build.LAUNCHES[name]
    got = roofline.lone_chain(F, a, b, 9, product)
    assert _build.LAUNCHES[name] == before + 1
    assert torch.equal(got, roofline.lone_chain_plain(F, a, b, 9))


@pytest.mark.parametrize("warps", [None, 4])
@pytest.mark.parametrize("body", sorted(issue_rates.BODIES))
def test_k7c_matches_plain(dev, body, warps):
    rng = np.random.default_rng(13)
    a = roofline.random_words((4099,), rng, dev)
    b = roofline.random_words((4099,), rng, dev)
    before = _build.LAUNCHES["K7c"]
    got = issue_rates.issue_body(body, a, b, 64, warps)
    assert _build.LAUNCHES["K7c"] == before + 1
    assert torch.equal(got, issue_rates.issue_body_plain(body, a, b, 64))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_k1e_matches_plain_on_non_canonical_values(dev, dc, op):
    # 256-bit words, most of them >= p, as K7e's XOR-fed chains give them
    rng = np.random.default_rng(14)
    a = roofline.random_words((8, 4099), rng, dev)
    b = roofline.random_words((8, 4099), rng, dev)
    a[:, 0], b[:, 0] = -1, -1                        # 2^256 - 1
    assert torch.equal(fp_op(dc.fq, op, a, b), fp_op_plain(dc.fq, op, a, b))


def _inv_inputs(F, n: int, seed: int, dev):
    """Arrays of n random elements of F (Fp or Fq2) on dev with edge
    values of chip_smoke.inv_edges first: at n = 1 one array for each
    edge, else one with all of them."""
    edges = list(chip_smoke.inv_edges(F).values())
    rng = np.random.default_rng(seed)
    xs = []
    for rows in ([[v] for v in edges] if n == 1 else [edges]):
        a = chip_smoke.rand_elements(F, n, rng, dev)
        for i in range(len(rows[0])):
            limbs = F.prime_field.plain_from_ints([r[i] for r in rows], dev)
            if F.el_ndim == 1:
                a[:, :len(rows)] = limbs
            else:
                a[i, :, :len(rows)] = limbs
        xs.append(a)
    return xs


@pytest.mark.parametrize("n", [1, 4099])
def test_k1e_inv_matches_plain(dev, dc, n):
    """K1e inv, one launch whatever n, against pow_static's ladder on the
    plain field: at one element (to_affine's shape) on 0, 1, p - 1 and R
    mod p, and at 4099 with those first."""
    F = dc.fq
    for a in _inv_inputs(F, n, 40, dev):
        before = dict(_build.LAUNCHES)
        got = F.inv(a)
        assert _build.LAUNCHES["K1e inv"] == before.get("K1e inv", 0) + 1
        assert _build.LAUNCHES["K1e"] == before.get("K1e", 0)
        assert torch.equal(got, fp_inv_plain(F, a))


@pytest.mark.parametrize("n", [1, 4099])
def test_k4e_inv_matches_plain(dev, dc, n):
    """K4e inv, one launch whatever n, against the norm, the plain ladder
    and the two products on the plain field, with the edge values."""
    F2 = dc.fq2
    for a in _inv_inputs(F2, n, 50, dev):
        before = dict(_build.LAUNCHES)
        got = F2.inv(a)
        assert _build.LAUNCHES["K4e inv"] == before.get("K4e inv", 0) + 1
        assert sum(_build.LAUNCHES.values()) == sum(before.values()) + 1
        assert torch.equal(got, fq2_inv_plain(F2, a))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_to_affine_makes_one_inverse_launch(dev, dc, group):
    """to_affine of one point: its z's inverse is one K1e inv (G1) or K4e
    inv (G2) launch, and the point equals the CPU's to_affine."""
    G = getattr(dc, group)
    rng = np.random.default_rng(60)
    P = JacobianPoint(*(chip_smoke.rand_elements(G.F, 1, rng, dev)[..., 0]
                        for _ in range(3)))
    name = "K1e inv" if group == "g1" else "K4e inv"
    before = dict(_build.LAUNCHES)
    A = G.to_affine(P)
    launched = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                if v != before.get(k, 0)}
    assert launched[name] == 1
    assert not any(k.endswith(" inv") for k in launched if k != name)
    W = G.to_affine(JacobianPoint(*(x.cpu() for x in P)))
    for g, w in zip(A, W):
        assert torch.equal(g.cpu(), w)


def test_inverses_refuse_what_the_kernels_do_not_take(dev, dc):
    """The kernels are built for 8 and 12 limbs and, on Fq2, nr = p - 1
    (and p - 5 at 12 limbs): a CUDA tensor of another field raises, never
    falls back."""
    from tests.test_pallas_interpret import P_TOY

    T = PrimeField(P_TOY, name="toy_Fp")
    with pytest.raises(NotImplementedError):
        T.inv(T.from_ints([1, 2], dev))
    F2 = ExtField(dc.fq, hf.Ext(dc.cd.fq, 2, 2))
    with pytest.raises(NotImplementedError):
        F2.inv(F2.from_host_batch([(1, 2), (3, 4)], dev))


@pytest.fixture(scope="module")
def k7e_case(dev, dc):
    """K7e inputs, I = 3, T = 4, Ls = 4, with x1 == x2 forced for the
    affine body in lanes 0-7 of instance 0 at step 1."""
    a, b = affine_experiment.random_inputs(dc.fq, 3, 4, 512, 15, dev)
    o1 = affine_experiment.affine_body_plain(dc.fq, a[:, :1], b[:, :1])
    a[0, 1, :, :8] = o1[0, :, :8]
    return a, b


@pytest.mark.parametrize("steps", [4, 2])
@pytest.mark.parametrize("body", ["madd", "affine", "lane_inv"])
def test_k7e_matches_plain(dev, dc, k7e_case, body, steps):
    ae = affine_experiment
    a, b = (x[:, :steps] for x in k7e_case)         # a view at steps < 4
    runs = {"madd": (lambda: ae.madd_body(dc.g1, a, b),
                     lambda: ae.madd_body_plain(dc.g1, a, b)),
            "affine": (lambda: ae.affine_body(dc.fq, a, b),
                       lambda: ae.affine_body_plain(dc.fq, a, b)),
            "lane_inv": (lambda: ae.lane_inv(dc.fq, a),
                         lambda: ae.lane_inv_plain(dc.fq, a))}
    name = ae.BODIES[body][1]
    before = _build.LAUNCHES[name]
    kernel, plain = runs[body]
    got, want = kernel(), plain()
    assert _build.LAUNCHES[name] == before + 1
    if body == "lane_inv":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        # every product is of nonzero residues, so o = suf
        x = to16(a[:, -1].permute(1, 0, 2).reshape(8, 3, 1, 4, 128))
        suf = ae.lane_scans(dc.fq.plain, x)[1]
        want_o = to32(suf).reshape(8, 3, 512).transpose(0, 1)
        assert torch.equal(got[0], want_o)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("Ls", [1, 2])
def test_k7e_lane_inv_matches_plain_at_fewer_rows(dev, dc, Ls):
    a, _ = affine_experiment.random_inputs(dc.fq, 2, 2, Ls * 128, 16, dev)
    got = affine_experiment.lane_inv(dc.fq, a)
    want = affine_experiment.lane_inv_plain(dc.fq, a)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k7e_refuses_other_fields_and_rows(dev, dc):
    from libff_tpu_torch.fields.fp import PrimeField
    a, b = affine_experiment.random_inputs(dc.fq, 1, 2, 640, 17, dev)
    with pytest.raises(ValueError):                 # 5 rows
        affine_experiment.lane_inv(dc.fq, a)
    with pytest.raises(NotImplementedError):
        affine_experiment.affine_body(PrimeField(dc.fr.p), a, b)


def test_k7e_time_doubles_with_steps(dev, dc):
    """Each body's time at T = 256 is 2x its time at T/2 within 10%, at two
    waves of instances: no step's work is dropped."""
    ae = affine_experiment
    inst = ae.default_instances(ae.kernel_info(4, dev))
    a, b = ae.random_inputs(dc.fq, max(inst.values()), 256, 512, 18, dev)
    runs = {"madd": lambda x, y: ae.madd_body(dc.g1, x, y),
            "affine": lambda x, y: ae.affine_body(dc.fq, x, y),
            "lane_inv": lambda x, y: ae.lane_inv(dc.fq, x)}
    for name, fn in runs.items():
        x, y = a[:inst[name]], b[:inst[name]]
        full = ae.best_ms(lambda: fn(x, y))[0]
        half = ae.best_ms(lambda: fn(x[:, :128], y[:, :128]))[0]
        assert 1.8 <= full / half <= 2.2, (name, full, half)


# -- the 12-limb kernels: BLS12-381 and BLS12-377 G1 ---------------------------

CURVES12 = ["bls12_381", "bls12_377"]


@pytest.fixture(scope="module")
def dc12():
    return {name: device_curve(name) for name in CURVES12}


@pytest.mark.parametrize("curve", CURVES12)
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_k1e_n12_matches_plain(dev, dc12, curve, op):
    """K1e over 12-limb Fq, every pair of edge values first, one launch
    counted as "K1e n12"."""
    F = dc12[curve].fq
    rng = np.random.default_rng(70)
    a, b = (chip_smoke.rand_elements(F, 4099, rng, dev) for _ in range(2))
    edges = workload.edge_values(F)
    pairs = [(x, y) for x in edges for y in edges]
    a[:, :len(pairs)] = F.plain_from_ints([x for x, _ in pairs], dev)
    b[:, :len(pairs)] = F.plain_from_ints([y for _, y in pairs], dev)
    before = _build.LAUNCHES["K1e n12"]
    got = fp_op(F, op, a, b)
    assert _build.LAUNCHES["K1e n12"] == before + 1
    assert torch.equal(got, fp_op_plain(F, op, a, b))


@pytest.mark.parametrize("curve", CURVES12)
@pytest.mark.parametrize("n", [1, 4099])
def test_k1e_inv_n12_matches_plain(dev, dc12, curve, n):
    """K1e inv over 12-limb Fq, one launch, on the edge values."""
    F = dc12[curve].fq
    for a in _inv_inputs(F, n, 71, dev):
        before = dict(_build.LAUNCHES)
        got = F.inv(a)
        assert _build.LAUNCHES["K1e inv n12"] == \
            before.get("K1e inv n12", 0) + 1
        assert sum(_build.LAUNCHES.values()) == sum(before.values()) + 1
        assert torch.equal(got, fp_inv_plain(F, a))


@pytest.mark.parametrize("curve", CURVES12)
@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("n", [1, 127, 129, 3000, 1 << 21])
def test_k3_n12_matches_plain(dev, dc12, curve, op, n):
    """K3's G1 branch over 12-limb Fp (b3 = 12 and 3; the projective ops
    on the pair body, two threads an element) with the edge lanes of
    chip_smoke.k3_inputs where n holds them: one element, a ragged last
    block on either side of 128 (a pair body's block is 64 elements),
    and the path's 2^21."""
    G = dc12[curve].g1
    c, cm, q_inf = chip_smoke.k3_inputs(G.F, max(n, 3000),
                                        np.random.default_rng(72), dev)
    c, cm = [a[..., :n] for a in c], [a[..., :n] for a in cm]
    q_inf = q_inf[:n]
    coords, masks = {"padd": (c, ()), "add": (c, ()), "pdbl": (c[:3], ()),
                     "dbl": (c[:3], ()), "pmadd": (list(cm), (q_inf,)),
                     "madd": (list(cm), (q_inf,))}[op]
    before = _build.LAUNCHES["K3 g1 n12"]
    got = group_op(G, op, coords, masks)
    assert _build.LAUNCHES["K3 g1 n12"] == before + 1
    for g, w in zip(got, group_op_plain(G, op, coords, masks)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("curve,group", [("alt_bn128", "g1"),
                                         ("alt_bn128", "g2"),
                                         ("bls12_381", "g1"),
                                         ("bls12_377", "g1")])
def test_k3_reads_halves_in_place(dev, curve, group):
    """The reduce's lane halving: padd on the two halves of (el, W, B, L)
    buckets at every level from L = 1024 down to 1, read where they lie
    (no copy), against the kernel on contiguous copies and against
    group_op_plain; and Group.padd on them launches K3 once."""
    G = getattr(device_curve(curve), group)
    rng = np.random.default_rng(79)
    b = [chip_smoke.rand_elements(G.F, 2 * 4 * 1024, rng, dev)
         .reshape(G.F.el_shape + (2, 4, 1024)) for _ in range(3)]
    while b[0].shape[-1] > 1:
        half = b[0].shape[-1] // 2
        hv = [a[..., :half] for a in b] + [a[..., half:] for a in b]
        assert not hv[0].is_contiguous() or half == 1
        got = group_op(G, "padd", hv)
        for g, c, w in zip(got,
                           group_op(G, "padd", [a.contiguous() for a in hv]),
                           group_op_plain(G, "padd", hv)):
            assert g.shape == hv[0].shape
            assert torch.equal(g, c) and torch.equal(g, w)
        b = got
    name = _build.width_name(f"K3 {group}", G.F.prime_field.n32)
    P = ProjectivePoint(*hv[:3])
    before = _build.LAUNCHES[name]
    G.padd(P, ProjectivePoint(*hv[3:]))
    assert _build.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("curve", CURVES12)
@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("W", [1, 2, 5, 32])
def test_k3_scan_n12_matches_plain(dev, dc12, curve, W, c):
    """The 12-limb scan's lane body (each product's operands handed to its
    lane, chain_mul.cuh's product) against horner_scan_plain."""
    G = dc12[curve].g1
    tot = chip_smoke.scan_inputs(G.F, W, np.random.default_rng(73 + W), dev)
    before = _build.LAUNCHES["K3 scan g1 n12"]
    got = horner_scan(G, tot, c)
    assert _build.LAUNCHES["K3 scan g1 n12"] == before + 1
    for g, w in zip(got, horner_scan_plain(G, tot, c)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("curve", CURVES12)
def test_k2_n12_matches_plain(dev, dc12, curve):
    """K2 over 12-limb Fp on distinct points, some at infinity, and on
    chip_smoke.skewed's digits (one bucket a lane, zero digits, the last
    bucket, every point at infinity)."""
    dc = dc12[curve]
    d, pts, B = chip_smoke.k2_inputs(dc, "g1", 1 << 12,
                                     MsmConfig(c=8, lanes=256),
                                     np.random.default_rng(74), dev)
    assert bool(pts[3].any())
    before = _build.LAUNCHES["K2 g1 n12"]
    got = insert(dc.g1, d, pts, B)
    assert _build.LAUNCHES["K2 g1 n12"] == before + 1
    for g, w in zip(got, insert_plain(dc.g1, d, pts, B)):
        assert torch.equal(g, w)
    ds, ps = chip_smoke.skewed(d, pts, B)
    for g, w in zip(insert(dc.g1, ds, ps, B), insert_plain(dc.g1, ds, ps, B)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("curve", CURVES12)
def test_k2_n12_matches_plain_with_several_chain_threads(dev, dc12, curve):
    """K2 over 12-limb Fp at T = 1024 steps of 128 lanes (several chain
    threads a lane), 4 windows, on distinct points and on
    chip_smoke.skewed's digits."""
    dc = dc12[curve]
    d, pts, B = chip_smoke.k2_inputs(dc, "g1", 1 << 17,
                                     MsmConfig(c=8, lanes=128),
                                     np.random.default_rng(78), dev)
    d = d[:4].contiguous()
    for dd, pp in ((d, pts), chip_smoke.skewed(d, pts, B)):
        before = _build.LAUNCHES["K2 g1 n12"]
        got = insert(dc.g1, dd, pp, B)
        assert _build.LAUNCHES["K2 g1 n12"] == before + 1
        for g, w in zip(got, insert_plain(dc.g1, dd, pp, B)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("curve", CURVES12)
def test_k2_g2_n12_matches_plain_with_several_chain_threads(dev, dc12,
                                                            curve):
    """K2 over 12-limb Fq2 (a chain thread on a pair of threads) at T =
    200 steps of 16 lanes (3 chain threads a lane at the default 86
    entries), 3 windows: 144 pairs, so the last block of 128 threads is a
    quarter full; on distinct points and on chip_smoke.skewed's
    digits."""
    dc = dc12[curve]
    d, pts, B = chip_smoke.k2_inputs(dc, "g2", 200 * 16,
                                     MsmConfig(c=8, lanes=16),
                                     np.random.default_rng(79), dev)
    d = d[:3].contiguous()
    for dd, pp in ((d, pts), chip_smoke.skewed(d, pts, B)):
        before = _build.LAUNCHES["K2 g2 n12"]
        got = insert(dc.g2, dd, pp, B)
        assert _build.LAUNCHES["K2 g2 n12"] == before + 1
        for g, w in zip(got, insert_plain(dc.g2, dd, pp, B)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("curve", CURVES12)
def test_msm_n12_matches_oracle(dev, dc12, curve):
    """The 12-limb G1 MSM through default_config(n, G): the oracle's
    point, one scan and one inverse launch, every 12-limb kernel launched
    and no 8-limb one."""
    dc = dc12[curve]
    s, A, want = workload.msm_case(dc, "g1", 12, dev, 75)
    _build.LAUNCHES.clear()
    got, _, _ = workload.run_msm(dc.g1, s, A,
                                 default_config(1 << 12, dc.g1, dev))
    assert got == want
    n = _build.LAUNCHES
    assert n["K3 scan g1 n12"] == 1 and n["K1e inv n12"] == 1
    assert n["K2 g1 n12"] == 1 and n["K3 g1 n12"] > 0 and n["K1e n12"] > 0
    assert not [k for k in n if not k.endswith("n12") and k != "K2 sort g1"]


@pytest.mark.parametrize("curve", CURVES12)
@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "neg"])
def test_k4e_n12_matches_plain(dev, dc12, curve, op):
    """K4e (mul, sqr) and K1e's Fq2 branch (add, sub, neg) over 12-limb
    Fq2, nr = p - 1 (BLS12-381) and p - 5 (BLS12-377), every pair of edge
    coefficients first: one launch, counted as "K4e n12" or "K1e n12"."""
    F2 = dc12[curve].fq2
    B = F2.B
    rng = np.random.default_rng(80)
    a, b = (chip_smoke.rand_elements(F2, 4099, rng, dev) for _ in range(2))
    edges = workload.edge_values(B)
    pairs = [(x, y) for x in edges for y in edges]
    for i, j in ((0, 1), (1, 0)):
        a[i, :, :len(pairs)] = B.plain_from_ints([q[i] for q in pairs], dev)
        b[j, :, :len(pairs)] = B.plain_from_ints([q[i] for q in pairs], dev)
    if op == "neg":
        op, a = "sub", torch.zeros_like(a)
    name = "K4e n12" if op in ("mul", "sqr") else "K1e n12"
    before = dict(_build.LAUNCHES)
    got = fq2_op(F2, op, a, b)
    assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    assert sum(_build.LAUNCHES.values()) == sum(before.values()) + 1
    assert torch.equal(got, fq2_op_plain(F2, op, a, b))


@pytest.mark.parametrize("curve", CURVES12)
@pytest.mark.parametrize("n", [1, 4099])
def test_k4e_inv_n12_matches_plain(dev, dc12, curve, n):
    """K4e inv over 12-limb Fq2, one launch, on the edge values (0, 1, u,
    p - 1 + (p - 1) u, R): at one element each, and at 4099 with them
    first."""
    F2 = dc12[curve].fq2
    for a in _inv_inputs(F2, n, 81, dev):
        before = dict(_build.LAUNCHES)
        got = F2.inv(a)
        assert _build.LAUNCHES["K4e inv n12"] == \
            before.get("K4e inv n12", 0) + 1
        assert sum(_build.LAUNCHES.values()) == sum(before.values()) + 1
        assert torch.equal(got, fq2_inv_plain(F2, a))


@pytest.mark.parametrize("curve", CURVES12)
@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("n", [1, 2, 35, 129, 3000])
def test_k3_g2_n12_matches_plain(dev, dc12, curve, op, n):
    """K3's G2 branch over 12-limb Fq2 (two threads an element, padd and
    pmadd four; nr = -1 and -5) with the edge lanes of
    chip_smoke.k3_inputs where n holds them: one element, ragged last
    blocks (64 elements a block on pairs, 32 on quads) and 3000."""
    G = dc12[curve].g2
    c, cm, q_inf = chip_smoke.k3_inputs(G.F, 3000,
                                        np.random.default_rng(82), dev)
    c, cm = [a[..., :n] for a in c], [a[..., :n] for a in cm]
    q_inf = q_inf[:n]
    coords, masks = {"padd": (c, ()), "add": (c, ()), "pdbl": (c[:3], ()),
                     "dbl": (c[:3], ()), "pmadd": (list(cm), (q_inf,)),
                     "madd": (list(cm), (q_inf,))}[op]
    before = _build.LAUNCHES["K3 g2 n12"]
    got = group_op(G, op, coords, masks)
    assert _build.LAUNCHES["K3 g2 n12"] == before + 1
    for g, w in zip(got, group_op_plain(G, op, coords, masks)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("curve", CURVES12)
def test_k3_g2_n12_reads_halves_in_place(dev, dc12, curve):
    """The 12-limb G2 padd on the two halves of (2, 12, 2, 4, L) buckets
    at every lane-halving level, read in place, against group_op_plain."""
    G = dc12[curve].g2
    rng = np.random.default_rng(83)
    b = [chip_smoke.rand_elements(G.F, 2 * 4 * 256, rng, dev)
         .reshape(G.F.el_shape + (2, 4, 256)) for _ in range(3)]
    while b[0].shape[-1] > 1:
        half = b[0].shape[-1] // 2
        hv = [a[..., :half] for a in b] + [a[..., half:] for a in b]
        got = group_op(G, "padd", hv)
        for g, w in zip(got, group_op_plain(G, "padd", hv)):
            assert torch.equal(g, w)
        b = got


@pytest.mark.parametrize("curve", CURVES12)
@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("W", [1, 2, 5, 32])
def test_k3_scan_g2_n12_matches_plain(dev, dc12, curve, W, c):
    """The 12-limb G2 scan (each level's base products through shared
    memory, chain_mul.cuh's product) against horner_scan_plain."""
    G = dc12[curve].g2
    tot = chip_smoke.scan_inputs(G.F, W, np.random.default_rng(84 + W), dev)
    before = _build.LAUNCHES["K3 scan g2 n12"]
    got = horner_scan(G, tot, c)
    assert _build.LAUNCHES["K3 scan g2 n12"] == before + 1
    for g, w in zip(got, horner_scan_plain(G, tot, c)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("curve", CURVES12)
def test_k2_g2_n12_matches_plain(dev, dc12, curve):
    """K2 over 12-limb Fq2 on 4 windows of distinct points, some at
    infinity, and on chip_smoke.skewed's digits (one bucket a lane, zero
    digits, the last bucket, every point at infinity)."""
    dc = dc12[curve]
    d, pts, B = chip_smoke.k2_inputs(dc, "g2", 1 << 12,
                                     MsmConfig(c=8, lanes=256),
                                     np.random.default_rng(85), dev)
    d = d[:4].contiguous()
    assert bool(pts[3].any())
    for dd, pp in ((d, pts), chip_smoke.skewed(d, pts, B)):
        before = _build.LAUNCHES["K2 g2 n12"]
        got = insert(dc.g2, dd, pp, B)
        assert _build.LAUNCHES["K2 g2 n12"] == before + 1
        for g, w in zip(got, insert_plain(dc.g2, dd, pp, B)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("curve", CURVES12)
def test_msm_g2_n12_matches_oracle(dev, dc12, curve):
    """The 12-limb G2 MSM through default_config(n, G): the oracle's
    point, one scan, one K2 and one inverse launch, every 12-limb G2
    kernel launched and no 8-limb one."""
    dc = dc12[curve]
    s, A, want = workload.msm_case(dc, "g2", 10, dev, 86)
    _build.LAUNCHES.clear()
    got, _, _ = workload.run_msm(dc.g2, s, A,
                                 default_config(1 << 10, dc.g2, dev))
    assert got == want
    n = _build.LAUNCHES
    assert n["K3 scan g2 n12"] == 1 and n["K4e inv n12"] == 1
    assert n["K2 g2 n12"] == 1 and n["K2 sort g2"] == 1
    assert n["K3 g2 n12"] > 0 and n["K4e n12"] > 0 and n["K1e n12"] > 0
    assert not [k for k in n if not k.endswith("n12") and k != "K2 sort g2"]


# the settings that run K5, K2m, K6 and the SOS products at 12 limbs:
# every MsmConfig setting of the 8-limb paths (chip_smoke.MSM_VARIANTS)
KMULS = ["cios", "sos", "sos2"]
# steps of the 12-limb K2m checks: above insert.cuh's 12-limb kEntries
# (342 on G1, 86 a pair on G2), so the chain kernel runs 2 threads a lane
K2M_N12_STEPS = {"g1": 350, "g2": 90}


@pytest.fixture(scope="module")
def n12_case(dev, dc12):
    """Per (curve, group): distinct points (some at infinity) through the
    path's digits at c = 8, 128 lanes and K2M_N12_STEPS steps, cut to 2
    windows, with the plain raw buckets and their plain lane totals."""
    out = {}
    for curve in CURVES12:
        dc = dc12[curve]
        for group in ("g1", "g2"):
            G = getattr(dc, group)
            T = K2M_N12_STEPS[group]
            d, pts, B = chip_smoke.k2_inputs(dc, group, T * 128,
                                             MsmConfig(c=8, lanes=128),
                                             np.random.default_rng(87), dev)
            d = d[:2].contiguous()
            raw = insert_plain(G, d, pts, B)
            out[curve, group] = (G, d, pts, B, raw,
                                 merge_lanes_plain(G, raw))
    return out


@pytest.mark.parametrize("curve", CURVES12)
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("kmul", KMULS)
def test_k2_k2m_k5_n12_match_plain(dev, n12_case, curve, group, kmul):
    """At 12 limbs under each kmul: K2 (raw buckets) against insert_plain,
    K5 on them and K2m (the fused merge, two chain threads a lane) against
    merge_lanes_plain, each one launch under its own name ("K2 g1 n12
    sos", ...), K2m never counted as K5."""
    G, d, pts, B, raw, merged = n12_case[curve, group]
    for name, fn, want in (
            ("K2", lambda: insert(G, d, pts, B, kmul=kmul), raw),
            ("K5", lambda: merge_lanes(G, raw, kmul), merged),
            ("K2m", lambda: insert(G, d, pts, B, merge=True, kmul=kmul),
             merged)):
        key = _build.kmul_name(f"{name} {group} n12", kmul)
        before = dict(_build.LAUNCHES)
        got = fn()
        assert _build.LAUNCHES[key] == before.get(key, 0) + 1
        assert {k for k, v in _build.LAUNCHES.items()
                if v != before.get(k, 0)} <= {key, f"K2 sort {group}"}
        for g, w in zip(got, want):
            assert torch.equal(g, w), (name, kmul)


@pytest.mark.parametrize("curve", CURVES12)
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("L", [1, 2, 16, 32, 64, 512, 1024, 2048])
def test_k5_n12_matches_plain_at_every_lane_count(dev, dc12, curve, group,
                                                  L):
    """K5 at 12 limbs under each kmul against merge_lanes_plain at lane
    counts from 1 to 2048 (the in-thread walk alone, the butterfly alone,
    both, and the far slots past the near ones), on 3 windows of 7 buckets
    with identity buckets and lanes at infinity (workload.merge_inputs)."""
    G = getattr(dc12[curve], group)
    raw = workload.merge_inputs(G, 3, 7, L, np.random.default_rng(L + 88),
                                dev)
    want = merge_lanes_plain(G, raw)
    for kmul in KMULS:
        name = _build.kmul_name(f"K5 {group} n12", kmul)
        before = _build.LAUNCHES[name]
        got = merge_lanes(G, raw, kmul)
        assert _build.LAUNCHES[name] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), kmul


@pytest.mark.parametrize("curve", CURVES12)
def test_k6_n12_matches_plain(dev, n12_case, curve):
    """K6, the v1 insert, over 12-limb Fp: insert_plain's raw buckets, one
    launch counted as "K6 g1 n12"; refused on G2 as at 8 limbs."""
    G, d, pts, B, raw, _ = n12_case[curve, "g1"]
    before = _build.LAUNCHES["K6 g1 n12"]
    got = insert_v1(G, d, pts, B)
    assert _build.LAUNCHES["K6 g1 n12"] == before + 1
    for g, w in zip(got, raw):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        insert_v1(*n12_case[curve, "g2"][:4])


@pytest.mark.parametrize("curve", CURVES12)
@pytest.mark.parametrize("group,key,fields,kernel", [
    (g, key, fields, kernel) for g in ("g1", "g2")
    for key, fields, kernel in chip_smoke.MSM_VARIANTS[g]])
def test_msm_n12_configs_match_oracle(dev, dc12, curve, group, key, fields,
                                      kernel):
    """Every MsmConfig setting beside the default on the 12-limb G1 and
    G2 MSMs (c = 8, 128 lanes): the oracle's point, the setting's kernel
    launched under its 12-limb name and no 8-limb kernel."""
    dc = dc12[curve]
    s, A, want = workload.msm_case(dc, group, 12 if group == "g1" else 10,
                                   dev, 89)
    _build.LAUNCHES.clear()
    got, _, _ = workload.run_msm(getattr(dc, group), s, A,
                                 MsmConfig(c=8, lanes=128, **fields))
    assert got == want, key
    n = _build.LAUNCHES
    assert n[chip_smoke.wide_name(kernel, 12)] == 1, (key, dict(n))
    assert not [k for k in n if " n12" not in k and not k.startswith(
        "K2 sort")], dict(n)


def test_width_without_kernel_raises_9d(dev):
    """A group over a field of no kernel width (the toy curve's p = 65539,
    2 limbs) raises naming ROADMAP item 10, which now owns the widths with
    no kernel (MNT4/MNT6's 10 limbs), on a CUDA tensor in every wrapper of
    this slice: none falls back to a plain version."""
    from libff_tpu_torch.curves.curvedef import GroupDef
    from libff_tpu_torch.curves.group import Group
    from libff_tpu_torch.host import ec as hec

    E = hec.WeierstrassCurve(hf.Fp(65539, name="toy_Fp"), 0, 11)
    G = Group(PrimeField(65539, name="toy_Fp"),
              GroupDef(name="toy", curve=E, generator=(2, 29831),
                       cofactor=1, order=65287, wnaf_window_table=(4,),
                       fixed_base_exp_window_table=(1,)))
    T, L, B = 3, 128, 4
    d = torch.ones((1, T, L), dtype=torch.int32, device=dev)
    x = G.F.from_ints([2] * (T * L), dev).reshape(-1, T, L)
    y = G.F.from_ints([29831] * (T * L), dev).reshape(-1, T, L)
    pts = (x, y, y, torch.zeros((T, L), dtype=torch.bool, device=dev))
    raw = ProjectivePoint(*(G.F.from_ints([1] * (B * L), dev)
                            .reshape(-1, 1, B, L) for _ in range(3)))
    for call in (lambda: merge_lanes(G, raw, "sos"),
                 lambda: insert(G, d, pts, B, merge=True, kmul="sos2"),
                 lambda: insert(G, d, pts, B, kmul="sos"),
                 lambda: insert_v1(G, d, pts, B)):
        with pytest.raises(NotImplementedError, match="item 10"):
            call()


# -- the 24-limb kernels: BW6-761's G1 (b3 = -3) and G2 over Fq (b3 = 12) -----

GROUPS24 = ["g1", "g2"]


@pytest.fixture(scope="module")
def dc24():
    return device_curve("bw6_761")


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_k1e_n24_matches_plain(dev, dc24, op):
    """K1e over 24-limb Fq, every pair of edge values first, one launch
    counted as "K1e n24"."""
    F = dc24.fq
    rng = np.random.default_rng(90)
    a, b = (chip_smoke.rand_elements(F, 4099, rng, dev) for _ in range(2))
    edges = workload.edge_values(F)
    pairs = [(x, y) for x in edges for y in edges]
    a[:, :len(pairs)] = F.plain_from_ints([x for x, _ in pairs], dev)
    b[:, :len(pairs)] = F.plain_from_ints([y for _, y in pairs], dev)
    before = _build.LAUNCHES["K1e n24"]
    got = fp_op(F, op, a, b)
    assert _build.LAUNCHES["K1e n24"] == before + 1
    assert torch.equal(got, fp_op_plain(F, op, a, b))


@pytest.mark.parametrize("n", [1, 4099])
def test_k1e_inv_n24_matches_plain(dev, dc24, n):
    """K1e inv over 24-limb Fq, one launch, on the edge values."""
    F = dc24.fq
    for a in _inv_inputs(F, n, 91, dev):
        before = dict(_build.LAUNCHES)
        got = F.inv(a)
        assert _build.LAUNCHES["K1e inv n24"] == \
            before.get("K1e inv n24", 0) + 1
        assert sum(_build.LAUNCHES.values()) == sum(before.values()) + 1
        assert torch.equal(got, fp_inv_plain(F, a))


@pytest.mark.parametrize("group", GROUPS24)
@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("n", [1, 129, 3000])
def test_k3_n24_matches_plain(dev, dc24, group, op, n):
    """K3's Fp branch over 24-limb Fq, b3 = -3 (G1) and 12 (G2), with the
    edge lanes of chip_smoke.k3_inputs where n holds them."""
    G = getattr(dc24, group)
    c, cm, q_inf = chip_smoke.k3_inputs(G.F, 3000,
                                        np.random.default_rng(92), dev)
    c, cm = [a[..., :n] for a in c], [a[..., :n] for a in cm]
    q_inf = q_inf[:n]
    coords, masks = {"padd": (c, ()), "add": (c, ()), "pdbl": (c[:3], ()),
                     "dbl": (c[:3], ()), "pmadd": (list(cm), (q_inf,)),
                     "madd": (list(cm), (q_inf,))}[op]
    before = _build.LAUNCHES["K3 g1 n24"]
    got = group_op(G, op, coords, masks)
    assert _build.LAUNCHES["K3 g1 n24"] == before + 1
    for g, w in zip(got, group_op_plain(G, op, coords, masks)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("group", GROUPS24)
@pytest.mark.parametrize("W,c", [(1, 4), (2, 1), (5, 3), (48, 8)])
def test_k3_scan_n24_matches_plain(dev, dc24, group, W, c):
    """The 24-limb scan's lane body over CIOS against horner_scan_plain,
    at the path's (48, 8) too."""
    G = getattr(dc24, group)
    tot = chip_smoke.scan_inputs(G.F, W, np.random.default_rng(93 + W), dev)
    before = _build.LAUNCHES["K3 scan g1 n24"]
    got = horner_scan(G, tot, c)
    assert _build.LAUNCHES["K3 scan g1 n24"] == before + 1
    for g, w in zip(got, horner_scan_plain(G, tot, c)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("group", GROUPS24)
def test_k2_n24_matches_plain_with_several_chain_threads(dev, dc24, group):
    """K2 over 24-limb Fq at T = 300 steps of 128 lanes (3 chain threads
    a lane at the default 128 entries), 2 windows, on distinct points
    (some at infinity) and on chip_smoke.skewed's digits."""
    G = getattr(dc24, group)
    d, pts, B = chip_smoke.k2_inputs(dc24, group, 300 * 128,
                                     MsmConfig(c=8, lanes=128),
                                     np.random.default_rng(94), dev)
    d = d[:2].contiguous()
    assert bool(pts[3].any())
    for dd, pp in ((d, pts), chip_smoke.skewed(d, pts, B)):
        before = _build.LAUNCHES["K2 g1 n24"]
        got = insert(G, dd, pp, B)
        assert _build.LAUNCHES["K2 g1 n24"] == before + 1
        for g, w in zip(got, insert_plain(G, dd, pp, B)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("group", GROUPS24)
def test_msm_n24_matches_oracle(dev, dc24, group):
    """BW6-761's MSM through default_config(n, G) at 2^12 points: the
    oracle's point, one K2, scan and inverse launch, every 24-limb kernel
    launched and no 8- or 12-limb one but K2's sort."""
    G = getattr(dc24, group)
    s, A, want = workload.msm_case(dc24, group, 12, dev, 95)
    _build.LAUNCHES.clear()
    got, _, _ = workload.run_msm(G, s, A, default_config(1 << 12, G, dev))
    assert got == want
    n = _build.LAUNCHES
    assert n["K3 scan g1 n24"] == 1 and n["K1e inv n24"] == 1
    assert n["K2 g1 n24"] == 1 and n["K3 g1 n24"] > 0 and n["K1e n24"] > 0
    assert not [k for k in n if not k.endswith("n24") and k != "K2 sort g1"]


# steps of the 24-limb K2m checks: above insert.cuh's 24-limb kEntries
# (128), so the chain kernel runs 2 threads a lane
K2M_N24_STEPS = 130


@pytest.fixture(scope="module")
def n24_case(dev, dc24):
    """Per group: distinct points (some at infinity) through the path's
    digits at c = 8, 128 lanes and K2M_N24_STEPS steps, cut to 1 window
    (the 24-limb plain insert takes its steps one after another), with
    the plain raw buckets and their plain lane totals."""
    out = {}
    for group in GROUPS24:
        G = getattr(dc24, group)
        d, pts, B = chip_smoke.k2_inputs(dc24, group, K2M_N24_STEPS * 128,
                                         MsmConfig(c=8, lanes=128),
                                         np.random.default_rng(97), dev)
        d = d[:1].contiguous()
        raw = insert_plain(G, d, pts, B)
        out[group] = (G, d, pts, B, raw, merge_lanes_plain(G, raw))
    return out


@pytest.mark.parametrize("group", GROUPS24)
@pytest.mark.parametrize("kmul", KMULS)
def test_k2_k2m_k5_n24_match_plain(dev, n24_case, group, kmul):
    """At 24 limbs under each kmul, on both groups (the Fp branch at b3 =
    -3 and 12): K2 (raw buckets) against insert_plain, K5 on them and K2m
    (two chain threads a lane) against merge_lanes_plain, each one launch
    under its own name ("K2 g1 n24 sos", ...), K2m never counted as K5."""
    G, d, pts, B, raw, merged = n24_case[group]
    for name, fn, want in (
            ("K2", lambda: insert(G, d, pts, B, kmul=kmul), raw),
            ("K5", lambda: merge_lanes(G, raw, kmul), merged),
            ("K2m", lambda: insert(G, d, pts, B, merge=True, kmul=kmul),
             merged)):
        key = _build.kmul_name(f"{name} g1 n24", kmul)
        before = dict(_build.LAUNCHES)
        got = fn()
        assert _build.LAUNCHES[key] == before.get(key, 0) + 1
        assert {k for k, v in _build.LAUNCHES.items()
                if v != before.get(k, 0)} <= {key, "K2 sort g1"}
        for g, w in zip(got, want):
            assert torch.equal(g, w), (name, kmul)


@pytest.mark.parametrize("group", GROUPS24)
@pytest.mark.parametrize("L", [1, 2, 32, 64, 512, 1024, 2048])
def test_k5_n24_matches_plain_at_every_lane_count(dev, dc24, group, L):
    """K5 at 24 limbs under each kmul against merge_lanes_plain at lane
    counts from 1 to 2048 (the in-thread walk alone, the butterfly alone,
    both, and the far slots past the near ones from L = 1024), on 3
    windows of 7 buckets with identity buckets and lanes at infinity."""
    G = getattr(dc24, group)
    raw = workload.merge_inputs(G, 3, 7, L, np.random.default_rng(L + 98),
                                dev)
    want = merge_lanes_plain(G, raw)
    for kmul in KMULS:
        name = _build.kmul_name("K5 g1 n24", kmul)
        before = _build.LAUNCHES[name]
        got = merge_lanes(G, raw, kmul)
        assert _build.LAUNCHES[name] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), kmul


@pytest.mark.parametrize("group", GROUPS24)
def test_k6_n24_matches_plain(dev, n24_case, group):
    """K6, the v1 insert, over 24-limb Fp on both groups (both over Fq):
    insert_plain's raw buckets, one launch counted as "K6 g1 n24"."""
    G, d, pts, B, raw, _ = n24_case[group]
    before = _build.LAUNCHES["K6 g1 n24"]
    got = insert_v1(G, d, pts, B)
    assert _build.LAUNCHES["K6 g1 n24"] == before + 1
    for g, w in zip(got, raw):
        assert torch.equal(g, w)


@pytest.mark.parametrize("group", GROUPS24)
@pytest.mark.parametrize("key,fields,kernel", chip_smoke.MSM_VARIANTS["g1"])
def test_msm_n24_configs_match_oracle(dev, dc24, group, key, fields,
                                      kernel):
    """Every MsmConfig setting beside the default on BW6-761's G1 and G2
    MSMs (c = 8, 128 lanes; both on the kernels' Fp branch, so both take
    every G1 setting, K6 among them): the oracle's point, the setting's
    kernel launched under its 24-limb name and no 8- or 12-limb kernel
    but K2's sort: nothing raises, nothing falls back to a plain
    version."""
    s, A, want = workload.msm_case(dc24, group, 10, dev, 96)
    _build.LAUNCHES.clear()
    got, _, _ = workload.run_msm(getattr(dc24, group), s, A,
                                 MsmConfig(c=8, lanes=128, **fields))
    assert got == want, key
    n = _build.LAUNCHES
    assert n[chip_smoke.wide_name(kernel, 24)] == 1, (key, dict(n))
    assert not [k for k in n if not k.endswith(" n24") and " n24 " not in k
                and k != "K2 sort g1"], dict(n)
