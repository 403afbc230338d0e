"""The 12-limb slice on the CPU: BLS12-381 and BLS12-377 G1, and the
Group and field host API, held against the JAX package through pinned
goldens.

The port runs both curves' G1 on 12 32-bit limbs (the JAX package's 24
16-bit limbs, R = 2^384).  On CPU tensors every kernel runs its plain
version, so these tests hold the plain versions of the 12-limb kernels
(K1e, K1e inv, K3's six ops and its scan, K2 inside the MSM) and the
Group API of ROADMAP Queue 1 item 8 against the JAX package's outputs,
written once from ``libff_tpu`` into tests/data/bls12_golden.json
(``PYTHONPATH=. python tests/test_torch_bls12.py`` from the repository
root writes it again).  No JAX program is compiled here.

- PrimeField add, sub, mul and inv on edge values and random elements;
- K3's padd, pmadd, pdbl, add, madd and dbl on lanes with P = 0, Q = 0,
  Q = P (scaled), Q = -P and Q at infinity;
- the scan (Horner's phase) at W = 4, c = 2;
- the signed Pippenger G1 MSM at n = 33 with MsmConfig(c=4, lanes=8),
  as tests/test_more_curves.py:107-138 runs it: its affine point equal
  to the golden's and to the host oracle ``E.msm`` (on the CPU the JAX
  package runs its XLA path, whose Jacobian coordinates scale
  differently from the complete path's that the port runs);
- eq, is_well_formed, neg, scalar_mul_int, scalar_mul_bits, sum_tree,
  zero and the generators; from_host, from_host_batch, to_host_batch
  and frobenius;
- MsmConfig and default_config as the JAX package's.

All comparisons are exact.  The file holds eleven test items, fewer
than tests/test_mesh_msm.py's thirteen: xdist's loadfile scheduler queues
files by their item count, so this one is handed out after that file
and does not delay the suite's longest file.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from libff_tpu.msm.pippenger import MsmConfig as JaxMsmConfig
from libff_tpu_torch import convert
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group import (AffinePoint, JacobianPoint,
                                          ProjectivePoint)
from libff_tpu_torch.curves.group_ops import (group_op, horner_scan,
                                              kernel_branch)
from libff_tpu_torch.host import field as hf
from libff_tpu_torch.msm.pippenger import (MsmConfig, default_config,
                                           msm_pippenger)

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "data" / "bls12_golden.json"
CURVES = ["bls12_381", "bls12_377"]
MSM_N = 33
SMUL_K = 0xB5A3                 # scalar_mul_int's k (16 bits: a short ladder)


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


# -- the inputs, made once from a seed and pinned in the golden ---------------

def _inputs(cd) -> dict:
    """Host inputs of one curve: field elements with edge values, six G1
    lanes of P and Q (Jacobian coordinates, the affine Q with its
    infinity flags) and four scan totals."""
    E, H = cd.g1.curve, cd.g1.curve.F
    p, gen = cd.q, cd.g1.generator
    rng = np.random.default_rng(int(cd.q % 1000))

    def rnd(bits=62):
        return int(rng.integers(1, 1 << bits))

    edges = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (1 << 384) % p,
             p - (1 << 384) % p]
    a = edges + [rnd() * rnd() * rnd() % p for _ in range(4)]
    b = edges[::-1] + [rnd() * rnd() * rnd() % p for _ in range(4)]

    def jac(P, z):
        if P is None:
            return (0, 1, 0)
        return (P[0] * z * z % p, P[1] * z * z * z % p, z)

    pts = [E.mul(rnd(), gen) for _ in range(6)]
    zs = [rnd() for _ in range(12)]
    P = [jac(pts[i], zs[i]) for i in range(6)]
    Q = [jac(E.mul(rnd(), gen), zs[6 + i]) for i in range(6)]
    P[1] = (0, 1, 0)                                   # P = 0
    Q[2] = (0, 1, 0)                                   # Q = 0
    Q[3] = jac(pts[3], zs[9] + 1)                      # Q = P, scaled
    Q[4] = jac(E.neg(pts[4]), zs[10])                  # Q = -P
    aff = [pts[i] if i in (3, 4) else E.mul(rnd(), gen) for i in range(6)]
    inf = [i == 2 for i in range(6)]
    scan = [jac(E.mul(rnd(), gen), rnd()) for _ in range(4)]
    scan[2] = (0, 1, 0)
    return {"a": a, "b": b, "P": [list(c) for c in zip(*P)],
            "Q": [list(c) for c in zip(*Q)],
            "A": [[q[0] for q in aff], [q[1] for q in aff], inf],
            "scan": [list(c) for c in zip(*scan)]}


def _msm_inputs(cd):
    """tests/test_more_curves.py:107-138's case: n = 33 SHA512 scalars (the
    second 0) and the points (i % 8 + 1) * gen."""
    E, gen = cd.g1.curve, cd.g1.generator
    ks = [hf.sha512_rng(cd.fr.mp, i) for i in range(MSM_N)]
    ks[1] = 0
    return ks, [E.mul((i % 8) + 1, gen) for i in range(MSM_N)]


# -- the port's side ----------------------------------------------------------

def _field(F, vals):
    return F.from_ints(vals, "cpu")


def _point(F, cols, kind=JacobianPoint):
    return kind(*(_field(F, c) for c in cols))


def _host(F, P):
    return [F.to_ints(c) for c in P]


@pytest.mark.parametrize("curve", CURVES)
def test_field_ops_match_jax(golden, curve):
    g = golden[curve]
    F = device_curve(curve).fq
    assert F.n32 == 12
    a, b = _field(F, g["a"]), _field(F, g["b"])
    for op in ("add", "sub", "mul"):
        assert F.to_ints(getattr(F, op)(a, b)) == g[op], op
    assert F.to_ints(F.inv(a)) == g["inv"]


@pytest.mark.parametrize("curve", CURVES)
def test_group_ops_and_scan_match_jax(golden, curve):
    """K3's six ops (plain) on every lane, b3 12 (BLS12-381) or 3
    (BLS12-377), the kernels' G1 branch at 12 limbs; then the scan."""
    g = golden[curve]
    G = device_curve(curve).g1
    assert kernel_branch(G, "K3") == (1, {"bls12_381": 12,
                                         "bls12_377": 3}[curve], None)
    P = [_field(G.F, c) for c in g["P"]]
    Q = [_field(G.F, c) for c in g["Q"]]
    A = [_field(G.F, c) for c in g["A"][:2]]
    inf = torch.tensor(g["A"][2])
    args = {"padd": (P + Q, ()), "add": (P + Q, ()), "pdbl": (P, ()),
            "dbl": (P, ()), "pmadd": (P + A, (inf,)),
            "madd": (P + A, (inf,))}
    for op, (coords, masks) in args.items():
        assert _host(G.F, group_op(G, op, coords, masks)) == g["ops"][op], op
    T = [_field(G.F, c) for c in g["scan"]]
    got = horner_scan(G, T, 2)
    assert [G.F.to_host(a) for a in got] == g["scan_sum"]


@pytest.mark.parametrize("curve", CURVES)
def test_msm_matches_jax_and_the_host_oracle(golden, curve):
    """The signed MSM at n = 33, MsmConfig(c=4, lanes=8), with the curve's
    Fr bits: the JAX package's affine point and the host oracle."""
    g = golden[curve]["msm"]
    dc = device_curve(curve)
    cd, G = dc.cd, dc.g1
    ks, pts = _msm_inputs(cd)
    A = AffinePoint(G.F.from_ints([q[0] for q in pts], "cpu"),
                    G.F.from_ints([q[1] for q in pts], "cpu"),
                    torch.zeros(MSM_N, dtype=torch.bool))
    out = msm_pippenger(G, dc.fr.plain_from_ints(ks, "cpu"), A,
                        cd.fr.mp.bits, config=MsmConfig(c=4, lanes=8))
    Aff = G.to_affine(out)
    got = (G.F.to_host(Aff.x), G.F.to_host(Aff.y))
    assert list(got) == g["affine"]
    assert got == cd.g1.curve.msm(ks, pts)


@pytest.mark.parametrize("curve", CURVES)
def test_group_api_matches_jax(golden, curve):
    """Item 8's Group API on the golden's lanes."""
    g = golden[curve]
    G = device_curve(curve).g1
    F = G.F
    P, Q = _point(F, g["P"]), _point(F, g["Q"])
    api = g["api"]
    assert G.eq(P, Q).tolist() == api["eq"]
    assert G.eq(P, P).all()
    off = JacobianPoint(P.x, F.add(P.y, F.one((6,), "cpu")), P.z)
    assert G.is_well_formed(P).tolist() == api["well_formed"]
    assert G.is_well_formed(off).tolist() == api["off_curve"]
    assert _host(F, G.neg(P)) == api["neg"]
    assert _host(F, G.scalar_mul_int(SMUL_K, P)) == api["smul"]
    assert _host(F, G.scalar_mul_int(-SMUL_K, P)) == api["smul_neg"]
    assert _host(F, G.scalar_mul_int(0, P)) == api["smul_0"]
    bits = torch.tensor([[int(c) for c in bin(SMUL_K)[2:]]] * 6).T
    assert _host(F, G.scalar_mul_bits(bits, P)) == api["smul"]
    for n in (5, 1):
        T = JacobianPoint(*(a[..., :n] for a in P))
        assert [F.to_host(a) for a in G.sum_tree(T)] == api[f"sum_tree_{n}"]


@pytest.mark.parametrize("curve", CURVES)
def test_constructors_and_host_api(golden, curve):
    """zero, generator, generator_affine, proj_is_zero; from_host,
    from_host_batch, to_host_batch (JAX's 16-bit Montgomery limbs in
    the golden) and frobenius on 12-limb Fq."""
    g = golden[curve]
    dc = device_curve(curve)
    G, F = dc.g1, dc.fq
    gx, gy = dc.cd.g1.generator
    Z = G.zero((3,), "cpu")
    assert G.is_zero(Z).all() and _host(F, Z) == [[0] * 3, [1] * 3, [0] * 3]
    assert _host(F, G.generator((2,), "cpu")) == [[gx] * 2, [gy] * 2, [1] * 2]
    A = G.generator_affine((2,), "cpu")
    assert (F.to_ints(A.x), F.to_ints(A.y)) == ([gx] * 2, [gy] * 2)
    assert not A.inf.any()
    Pp = ProjectivePoint(*_point(F, g["P"]))
    assert G.proj_is_zero(Pp).tolist() == [False, True] + [False] * 4
    x = F.from_host_batch(g["a"], "cpu")
    assert convert.field_from_torch(x).tolist() == g["a_limbs16"]
    assert F.to_host_batch(x) == g["a"]
    assert F.to_host(F.from_host(g["a"][5], "cpu")) == g["a"][5]
    assert F.frobenius(x, 3) is x


def test_msm_config_takes_the_references_fields():
    """The reference's eight fields in its order, positionally and by
    keyword; an unknown scatter or formulas raises."""
    assert MsmConfig._fields == JaxMsmConfig._fields
    for fields in ({}, {"scatter": "gather", "engine": "pallas3",
                        "formulas": "vm", "merge": "kernel", "tb": 8,
                        "kmul": "sos"}):
        ref = JaxMsmConfig(4, 8, **fields)
        assert tuple(MsmConfig(4, 8, **fields)) == tuple(ref)
        assert MsmConfig(*ref) == ref
    dc = device_curve("bls12_381")
    G = dc.g1
    assert default_config(1 << 20, G) == MsmConfig(c=8, lanes=1024)
    assert default_config(1 << 20, G, "cuda") == default_config(1 << 20)
    assert default_config(64, None, "cpu") == MsmConfig(c=4, lanes=32)
    ks, pts = _msm_inputs(dc.cd)
    s = dc.fr.plain_from_ints(ks[:4], "cpu")
    A = AffinePoint(G.F.from_ints([q[0] for q in pts[:4]], "cpu"),
                    G.F.from_ints([q[1] for q in pts[:4]], "cpu"),
                    torch.zeros(4, dtype=torch.bool))
    for bad in ({"scatter": "onehot"}, {"formulas": "rounds"}):
        with pytest.raises(ValueError):
            msm_pippenger(G, s, A, 255, config=MsmConfig(3, 1, **bad))


# -- the golden, from the JAX package -----------------------------------------

def _write_golden() -> None:
    """tests/data/bls12_golden.json from the JAX package on the CPU."""
    import jax.numpy as jnp

    from libff_tpu.curves.device import device_curve as jax_device_curve
    from libff_tpu.curves.group import AffinePoint as JA
    from libff_tpu.curves.group import JacobianPoint as JJ
    from libff_tpu.curves.group import ProjectivePoint as JP
    from libff_tpu.msm.pippenger import _horner_complete
    from libff_tpu.msm.pippenger import msm_pippenger as jax_msm

    out = {}
    for curve in CURVES:
        jdc = jax_device_curve(curve)
        JG, JF, cd = jdc.g1, jdc.g1.F, jdc.cd
        g = _inputs(cd)

        def col(v):
            return JF.from_ints(v)

        def host(Pt):
            return [JF.to_ints(c) for c in Pt]

        a, b = col(g["a"]), col(g["b"])
        for op in ("add", "sub", "mul"):
            g[op] = JF.to_ints(getattr(JF, op)(a, b))
        g["inv"] = JF.to_ints(JF.inv(a))
        g["a_limbs16"] = np.asarray(a).tolist()
        P, Q = (JJ(*(col(c) for c in g[k])) for k in ("P", "Q"))
        A = JA(col(g["A"][0]), col(g["A"][1]), jnp.asarray(g["A"][2]))
        PP, PQ = JP(*P), JP(*Q)
        g["ops"] = {"padd": host(JG.padd(PP, PQ)),
                    "pmadd": host(JG.pmadd(PP, A)),
                    "pdbl": host(JG.pdbl(PP)), "add": host(JG.add(P, Q)),
                    "madd": host(JG.mixed_add(P, A)), "dbl": host(JG.dbl(P))}
        T = JP(*(col(c) for c in g["scan"]))
        g["scan_sum"] = [JF.to_host(c)
                         for c in _horner_complete(JG, T, 2, direct="scan")]
        one = JF.one((6,))
        off = JJ(P.x, JF.add(P.y, one), P.z)
        g["api"] = {
            "eq": np.asarray(JG.eq(P, Q)).tolist(),
            "well_formed": np.asarray(JG.is_well_formed(P)).tolist(),
            "off_curve": np.asarray(JG.is_well_formed(off)).tolist(),
            "neg": host(JG.neg(P)),
            "smul": host(JG.scalar_mul_int(SMUL_K, P)),
            "smul_neg": host(JG.scalar_mul_int(-SMUL_K, P)),
            "smul_0": host(JG.scalar_mul_int(0, P))}
        for n in (5, 1):
            S = JG.sum_tree(JJ(*(c[..., :n] for c in P)))
            g["api"][f"sum_tree_{n}"] = [JF.to_host(c) for c in S]
        ks, pts = _msm_inputs(cd)
        JA_ = JA(JF.from_ints([q[0] for q in pts]),
                 JF.from_ints([q[1] for q in pts]),
                 jnp.zeros((MSM_N,), bool))
        R = jax_msm(JG, jdc.fr.plain_from_ints(ks), JA_, cd.fr.mp.bits,
                    config=JaxMsmConfig(c=4, lanes=8))
        Aff = JG.to_affine(JJ(*(c[..., None] for c in R)))
        g["msm"] = {"affine": [JF.to_ints(Aff.x)[0], JF.to_ints(Aff.y)[0]]}
        out[curve] = g
    GOLDEN.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    _write_golden()
