"""The 12-limb G2 slice on the CPU: BLS12-381 G2 (Fq2 with nr = p - 1)
and BLS12-377 G2 (nr = p - 5, the twist's b' = 1/u), held against the
JAX package through pinned goldens.

The port runs both curves' Fq2 on 2 x 12 32-bit limbs (the JAX
package's 2 x 24 16-bit limbs, R = 2^384).  On CPU tensors every kernel
runs its plain version, so these tests hold the plain versions of the
12-limb Fq2 and G2 kernels (K1e's Fq2 branch, K4e, K4e inv, K3's six ops
and its scan, K2 inside the MSM) against the JAX package's outputs,
written once from ``libff_tpu`` into tests/data/bls12_g2_golden.json
(``PYTHONPATH=. python tests/test_torch_bls12_g2.py`` from the
repository root writes it again).  No JAX program is compiled here.

- Fq2 add, sub, mul, sqr and inv on edge values (0, 1, p - 1, u, 1 + u,
  elements with one coefficient zero) and random elements;
- K3's padd, pmadd, pdbl, add, madd and dbl on lanes with P = 0, Q = 0,
  Q = P (scaled), Q = -P and Q at infinity, also as the card's pair
  schedule computes them (``group_op_pair_plain``, each product's lazy
  sum held to its bound), and padd and pmadd as its quad body does
  (``group_op_split_plain``: each level's Fq2 products split between two
  pairs);
- the scan (Horner's phase) at W = 4, c = 2;
- the signed Pippenger G2 MSM at n = 33 with MsmConfig(c=4, lanes=8):
  its affine point equal to the golden's and to the host oracle
  ``E.msm``, and its insert's first two windows walked as the card's
  pair chains (K2 on two threads a chain) against ``insert_plain``;
  and ``workload.msm_case``'s structured oracle against ``E.msm`` at 16
  points;
- ``convert``'s round trip of 12-limb Fq2 arrays, (2, 24, n) 16-bit <->
  (2, 12, n) 32-bit, on the JAX package's own arrays;
- the kernels' branch for each G2 and the non-residues they are built
  for.

All comparisons are exact.  The file holds ten test items, fewer than
tests/test_mesh_msm.py's thirteen (xdist's loadfile scheduler queues
files by their item count).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from libff_tpu_torch import convert, workload
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group import AffinePoint, JacobianPoint
from libff_tpu_torch.curves.group_ops import (PAIR_OPS, group_op,
                                              group_op_pair_plain,
                                              group_op_split_plain,
                                              horner_scan, kernel_branch)
from libff_tpu_torch.fields.tower import FQ2_NRS, ExtField, kernel_nr
from libff_tpu_torch.host import field as hf
from libff_tpu_torch.msm.insert import (bucket_lists_plain,
                                        insert_from_lists_plain, insert_plain)
from libff_tpu_torch.msm.pippenger import MsmConfig, msm_pippenger

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "data" / "bls12_g2_golden.json"
CURVES = ["bls12_381", "bls12_377"]
NR = {"bls12_381": -1, "bls12_377": -5}
MSM_N = 33


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


# -- the inputs, made once from a seed and pinned in the golden ---------------

def _inputs(cd) -> dict:
    """Host inputs of one curve: Fq2 elements with edge values, six G2
    lanes of P and Q (Jacobian coordinates, the affine Q with its
    infinity flags) and four scan totals; Fq2 values as [c0, c1]."""
    E = cd.g2.curve
    H, gen = E.F, cd.g2.generator
    p = cd.q
    rng = np.random.default_rng(int(cd.q % 1000) + 2)

    def rnd(bits=62):
        return int(rng.integers(1, 1 << bits))

    def r2():
        return (rnd() * rnd() * rnd() % p, rnd() * rnd() * rnd() % p)

    R = (1 << 384) % p
    edges = [(0, 0), (1, 0), (p - 1, 0), (0, 1), (1, 1), (p - 1, p - 1),
             (R, 0), (0, p - R), (rnd(), 0), (0, rnd())]
    a = edges + [r2() for _ in range(4)]
    b = edges[::-1] + [r2() for _ in range(4)]

    def jac(P, z):
        if P is None:
            return ((0, 0), (1, 0), (0, 0))
        z2 = H.sqr(z)
        return (H.mul(P[0], z2), H.mul(P[1], H.mul(z2, z)), z)

    pts = [E.mul(rnd(), gen) for _ in range(6)]
    zs = [r2() for _ in range(12)]
    P = [jac(pts[i], zs[i]) for i in range(6)]
    Q = [jac(E.mul(rnd(), gen), zs[6 + i]) for i in range(6)]
    P[1] = jac(None, None)                             # P = 0
    Q[2] = jac(None, None)                             # Q = 0
    Q[3] = jac(pts[3], H.add(zs[9], (1, 0)))           # Q = P, scaled
    Q[4] = jac(E.neg(pts[4]), zs[10])                  # Q = -P
    aff = [pts[i] if i in (3, 4) else E.mul(rnd(), gen) for i in range(6)]
    inf = [i == 2 for i in range(6)]
    scan = [jac(E.mul(rnd(), gen), r2()) for _ in range(4)]
    scan[2] = jac(None, None)

    def cols(points):
        return [[list(q[j]) for q in points] for j in range(3)]

    return {"a": [list(v) for v in a], "b": [list(v) for v in b],
            "P": cols(P), "Q": cols(Q),
            "A": [[list(q[0]) for q in aff], [list(q[1]) for q in aff], inf],
            "scan": cols(scan)}


def _msm_inputs(cd):
    """tests/test_more_curves.py:107-138's case on G2: n = 33 SHA512
    scalars (the second 0) and the points (i % 8 + 1) * gen."""
    E, gen = cd.g2.curve, cd.g2.generator
    ks = [hf.sha512_rng(cd.fr.mp, i) for i in range(MSM_N)]
    ks[1] = 0
    return ks, [E.mul((i % 8) + 1, gen) for i in range(MSM_N)]


# -- the port's side ----------------------------------------------------------

def _field(F, vals):
    return F.from_host_batch([tuple(v) for v in vals], "cpu")


def _host(F, cs):
    return [[list(v) for v in F.to_host_batch(c)] for c in cs]


@pytest.mark.parametrize("curve", CURVES)
def test_fq2_ops_match_jax(golden, curve):
    """add, sub, mul and sqr (K1e's Fq2 branch and K4e, plain) and inv
    (K4e inv's plain version, inv2 over pow_static) on 12-limb Fq2."""
    g = golden[curve]
    F = device_curve(curve).fq2
    assert F.n32 == 12 and F.nr == F.B.p + NR[curve]
    a, b = _field(F, g["a"]), _field(F, g["b"])
    for op in ("add", "sub", "mul"):
        assert _host(F, [getattr(F, op)(a, b)])[0] == g[op], op
    assert _host(F, [F.sqr(a)])[0] == g["sqr"]
    assert _host(F, [F.inv(a)])[0] == g["inv"]


@pytest.mark.parametrize("curve", CURVES)
def test_group_ops_and_scan_match_jax(golden, curve):
    """K3's six G2 ops (plain, and on the card's pair schedule; padd and
    pmadd also on its quad schedule) on every lane; then the scan at W =
    4, c = 2."""
    g = golden[curve]
    G = device_curve(curve).g2
    P = [_field(G.F, c) for c in g["P"]]
    Q = [_field(G.F, c) for c in g["Q"]]
    A = [_field(G.F, c) for c in g["A"][:2]]
    inf = torch.tensor(g["A"][2])
    args = {"padd": (P + Q, ()), "add": (P + Q, ()), "pdbl": (P, ()),
            "dbl": (P, ()), "pmadd": (P + A, (inf,)),
            "madd": (P + A, (inf,))}
    for op, (coords, masks) in args.items():
        assert _host(G.F, group_op(G, op, coords, masks)) == g["ops"][op], op
        assert _host(G.F, group_op_pair_plain(G, op, coords, masks)) == \
            g["ops"][op], op
        if op in PAIR_OPS:
            assert _host(G.F, group_op_split_plain(G, op, coords, masks)) \
                == g["ops"][op], op
    T = [_field(G.F, c) for c in g["scan"]]
    got = horner_scan(G, T, 2)
    assert [list(G.F.to_host(a)) for a in got] == g["scan_sum"]


@pytest.mark.parametrize("curve", CURVES)
def test_msm_matches_jax_and_the_host_oracle(golden, curve):
    """The signed G2 MSM at n = 33, MsmConfig(c=4, lanes=8), with the
    curve's Fr bits: the JAX package's affine point and the host oracle.
    Its insert's first two windows (T = 5 steps, 8 lanes) also walked as
    the card's pair chains (``insert_from_lists_plain(pair=True)``: each
    Fq2 product as a pair's lazy sums) with 2 entries a thread, so 3
    threads a lane: insert_plain's raw buckets."""
    g = golden[curve]["msm"]
    dc = device_curve(curve)
    cd, G = dc.cd, dc.g2
    ks, pts = _msm_inputs(cd)
    A = AffinePoint(G.F.from_host_batch([q[0] for q in pts], "cpu"),
                    G.F.from_host_batch([q[1] for q in pts], "cpu"),
                    torch.zeros(MSM_N, dtype=torch.bool))
    scalars = dc.fr.plain_from_ints(ks, "cpu")
    d, ipts, B = workload.insert_inputs(G, scalars, A,
                                        MsmConfig(c=4, lanes=8))
    d = d[:2].contiguous()
    got = insert_from_lists_plain(G, bucket_lists_plain(d, ipts[3], B), ipts,
                                  B, 2, pair=True)
    for a, b in zip(got, insert_plain(G, d, ipts, B)):
        assert torch.equal(a, b)
    out = msm_pippenger(G, scalars, A, cd.fr.mp.bits,
                        config=MsmConfig(c=4, lanes=8))
    Aff = G.to_affine(out)
    got = (G.F.to_host(Aff.x), G.F.to_host(Aff.y))
    assert [list(v) for v in got] == g["affine"]
    assert got == cd.g2.curve.msm(ks, pts)


@pytest.mark.parametrize("curve", CURVES)
def test_msm_case_matches_the_host_msm(curve):
    """workload.msm_case's G2 case (PERIOD["g2"] = 16 generator
    multiples) at 16 points: its structured oracle is the host E.msm of
    its own scalars and points."""
    dc = device_curve(curve)
    s, A, want = workload.msm_case(dc, "g2", 4, "cpu", 31)
    E, F = dc.cd.g2.curve, dc.fq2
    ks = dc.fr.plain_to_ints(s)
    pts = list(zip(F.to_host_batch(A.x), F.to_host_batch(A.y)))
    assert pts == [E.mul(i + 1, dc.cd.g2.generator) for i in range(16)]
    assert want == E.msm(ks, pts)


def test_convert_round_trips_12_limb_fq2(golden):
    """The JAX package's (2, 24, n) 16-bit Fq2 arrays (pinned in the
    golden) and the port's (2, 12, n) 32-bit ones: the same values both
    ways, and a G2 point batch through affine_to_torch."""
    for curve in CURVES:
        g = golden[curve]
        F = device_curve(curve).fq2
        j16 = np.asarray(g["a_limbs16"], dtype=np.uint32)
        assert j16.shape == (2, 24, len(g["a"]))
        t = convert.field_to_torch(j16, "cpu", 2)
        assert tuple(t.shape) == (2, 12, len(g["a"]))
        assert torch.equal(t, _field(F, g["a"]))
        assert np.array_equal(convert.field_from_torch(t, 2), j16)
        A = convert.affine_to_torch((j16, j16, np.zeros(j16.shape[-1], bool)),
                                    "cpu", 2)
        assert np.array_equal(convert.affine_from_torch(A, 2)[1], j16)


def test_kernel_branch_takes_each_g2_and_its_non_residue():
    """Each G2's kernel branch: k = 2, nr - p in place of b3 (-1 for
    alt_bn128 and BLS12-381, -5 for BLS12-377) and b3's 2 x n32
    Montgomery limbs; an Fq2 with a non-residue no kernel is built for
    (the toy nr = 2 over BLS12-381's Fq) has none."""
    for curve, nr in (("alt_bn128", -1), *NR.items()):
        dc = device_curve(curve)
        k, small, limbs = kernel_branch(dc.g2, "K3")
        assert (k, small) == (2, nr) and nr in FQ2_NRS[dc.fq.n32]
        assert list(limbs) == dc.fq2.mont_limbs(dc.g2._b3_host)
        assert kernel_nr(dc.fq2) == nr
    dc = device_curve("bls12_381")
    assert kernel_nr(ExtField(dc.fq, hf.Ext(dc.cd.fq, 2, 2))) is None
    J = JacobianPoint(*(dc.fq2.zero((2,), "cpu") for _ in range(3)))
    assert bool(dc.g2.is_zero(J).all())


# -- the golden, from the JAX package -----------------------------------------

def _write_golden() -> None:
    """tests/data/bls12_g2_golden.json from the JAX package on the CPU."""
    import jax.numpy as jnp

    from libff_tpu.curves.device import device_curve as jax_device_curve
    from libff_tpu.curves.group import AffinePoint as JA
    from libff_tpu.curves.group import JacobianPoint as JJ
    from libff_tpu.curves.group import ProjectivePoint as JP
    from libff_tpu.msm.pippenger import MsmConfig as JaxMsmConfig
    from libff_tpu.msm.pippenger import _horner_complete
    from libff_tpu.msm.pippenger import msm_pippenger as jax_msm

    out = {}
    for curve in CURVES:
        jdc = jax_device_curve(curve)
        JG, JF, cd = jdc.g2, jdc.g2.F, jdc.cd
        g = _inputs(cd)

        def col(v):
            return JF.from_host_batch([tuple(x) for x in v])

        def host(cs):
            return [[list(v) for v in JF.to_host_batch(c)] for c in cs]

        a, b = col(g["a"]), col(g["b"])
        for op in ("add", "sub", "mul"):
            g[op] = host([getattr(JF, op)(a, b)])[0]
        g["sqr"] = host([JF.sqr(a)])[0]
        g["inv"] = host([JF.inv(a)])[0]
        g["a_limbs16"] = np.asarray(a).tolist()
        P, Q = (JJ(*(col(c) for c in g[k])) for k in ("P", "Q"))
        A = JA(col(g["A"][0]), col(g["A"][1]), jnp.asarray(g["A"][2]))
        PP, PQ = JP(*P), JP(*Q)
        g["ops"] = {"padd": host(JG.padd(PP, PQ)),
                    "pmadd": host(JG.pmadd(PP, A)),
                    "pdbl": host(JG.pdbl(PP)), "add": host(JG.add(P, Q)),
                    "madd": host(JG.mixed_add(P, A)), "dbl": host(JG.dbl(P))}
        T = JP(*(col(c) for c in g["scan"]))
        g["scan_sum"] = [list(JF.to_host(c)) for c in
                         _horner_complete(JG, T, 2, direct="scan")]
        ks, pts = _msm_inputs(cd)
        JA_ = JA(JF.from_host_batch([q[0] for q in pts]),
                 JF.from_host_batch([q[1] for q in pts]),
                 jnp.zeros((MSM_N,), bool))
        R = jax_msm(JG, jdc.fr.plain_from_ints(ks), JA_, cd.fr.mp.bits,
                    config=JaxMsmConfig(c=4, lanes=8))
        Aff = JG.to_affine(JJ(*(c[..., None] for c in R)))
        g["msm"] = {"affine": [list(v[0]) for v in
                               (JF.to_host_batch(Aff.x),
                                JF.to_host_batch(Aff.y))]}
        out[curve] = g
        print(curve, "done", flush=True)
    GOLDEN.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    _write_golden()
