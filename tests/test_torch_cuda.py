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
from libff_tpu_torch.curves.group_ops import OPS, group_op, group_op_plain
from libff_tpu_torch.fields.fp import fp_op, fp_op_plain, to16, to32
from libff_tpu_torch.fields.tower import ExtField, fq2_op, fq2_op_plain
from libff_tpu_torch.host import field as hf
from libff_tpu_torch.msm.insert import insert, insert_plain, insert_v1
from libff_tpu_torch.msm.merge import merge_lanes, merge_lanes_plain
from libff_tpu_torch.msm.pippenger import MsmConfig
from libff_tpu_torch import affine_experiment, issue_rates, roofline

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
    """K4 is written for nr = p - 1; an Fq2 with another non-residue runs
    only on the plain version and is refused on the card."""
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


def test_k6_matches_plain(dev, k2_case):
    G, d, pts, B, raw, _ = k2_case["g1"]
    before = _build.LAUNCHES["K6 g1"]
    got = insert_v1(G, d, pts, B)
    assert _build.LAUNCHES["K6 g1"] == before + 1
    for g, w in zip(got, raw):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        insert_v1(k2_case["g2"][0], *k2_case["g2"][1:4])


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
