"""The 24-limb slice on the CPU: BW6-761's G1 and G2, both over its
761-bit Fq, held against the JAX package through a pinned golden.

The port runs BW6-761's Fq on 24 32-bit limbs (the JAX package's 48
16-bit limbs, R = 2^768).  G1 is y^2 = x^3 - 1 (b3 = p - 3, which the
kernels take as -3) and G2 the M-twist y^2 = x^3 + 4 over Fq itself (b3 =
12): both run the kernels' Fp branch.  On CPU tensors every kernel runs
its plain version, so these tests hold the plain versions of the 24-limb
kernels (K1e, K1e inv, K3's six ops and its scan, K2) against the JAX
package's outputs, written once from ``libff_tpu`` into
tests/data/bw6_golden.json (``PYTHONPATH=. python tests/test_torch_bw6.py``
from the repository root writes it again).  No JAX program is compiled
here.

- PrimeField add, sub, mul and inv on edge values and random elements;
- K3's padd, pmadd, pdbl, add, madd and dbl on G1 and G2 lanes with P =
  0, Q = 0, Q = P (scaled), Q = -P and Q at infinity, and the scan at W =
  4, c = 2;
- the plain insert at W = 2 windows, T = 4 steps, L = 128 lanes and B = 8
  buckets against ``insert_pallas3(..., interpret="reference")`` (by the
  raw buckets' SHA-256), on G1 and G2;
- the signed Pippenger G1 MSM at n = 33 with MsmConfig(c=4, lanes=8), as
  tests/test_more_curves.py:107-138 runs it: its affine point equal to the
  JAX package's and to the host oracle ``E.msm`` (the G2 MSM runs on the
  card only: its plain Horner scan alone takes about 20 s here);
- the kernels' branches, the 24-limb libraries and launch names (K5,
  K2m, K6 and the SOS products among them; their plain versions are
  held in tests/test_torch_bw6_merge.py), and the 377-bit scalars'
  signed digits.

All comparisons are exact.
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from libff_tpu_torch import _build
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group import AffinePoint
from libff_tpu_torch.curves.group_ops import (group_op, horner_scan,
                                              k3_stem, kernel_branch)
from libff_tpu_torch.host import field as hf
from libff_tpu_torch.issue_rates import imad_per_product
from libff_tpu_torch.msm import digits as dig
from libff_tpu_torch.msm.insert import insert_plain, lane_words
from libff_tpu_torch.msm.pippenger import MsmConfig, msm_pippenger

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "data" / "bw6_golden.json"
CURVE = "bw6_761"
GROUPS = ["g1", "g2"]
# the insert case: windows, steps, lanes (insert_pallas3 takes L % 128 ==
# 0), buckets (c = 4) and the generator multiples the points are drawn from
W, T, L, B, PERIOD = 2, 4, 128, 8, 16
MSM_N = 33


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


# -- the inputs, made once from a seed and pinned in the golden ---------------

def _inputs(cd) -> dict:
    """Host inputs: Fq elements with edge values; per group six lanes of P
    and Q (Jacobian coordinates, the affine Q with its infinity flags),
    four scan totals, and the insert case's signed digits (W, T, L), each
    step's point (an index into the generator multiples) and its infinity
    flag."""
    p = cd.q
    rng = np.random.default_rng(761)
    R = (1 << 768) % p

    def rnd():
        return int.from_bytes(rng.bytes(96), "little") % p

    def small():
        return int(rng.integers(1, 1 << 62))

    edges = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, R, p - R]
    out = {"a": edges + [rnd() for _ in range(4)],
           "b": edges[::-1] + [rnd() for _ in range(4)]}

    def jac(P, z):
        if P is None:
            return (0, 1, 0)
        return (P[0] * z * z % p, P[1] * z * z * z % p, z)

    for g in GROUPS:
        gd = getattr(cd, g)
        E, gen = gd.curve, gd.generator
        pts = [E.mul(small(), gen) for _ in range(6)]
        zs = [rnd() for _ in range(12)]
        P = [jac(pts[i], zs[i]) for i in range(6)]
        Q = [jac(E.mul(small(), gen), zs[6 + i]) for i in range(6)]
        P[1] = (0, 1, 0)                               # P = 0
        Q[2] = (0, 1, 0)                               # Q = 0
        Q[3] = jac(pts[3], zs[9] + 1)                  # Q = P, scaled
        Q[4] = jac(E.neg(pts[4]), zs[10])              # Q = -P
        aff = [pts[i] if i in (3, 4) else E.mul(small(), gen)
               for i in range(6)]
        scan = [jac(E.mul(small(), gen), rnd()) for _ in range(4)]
        scan[2] = (0, 1, 0)
        d = rng.integers(-B, B + 1, size=(W, T, L))
        d[rng.random((W, T, L)) < 0.2] = 0
        out[g] = {"P": [list(c) for c in zip(*P)],
                  "Q": [list(c) for c in zip(*Q)],
                  "A": [[q[0] for q in aff], [q[1] for q in aff],
                        [i == 2 for i in range(6)]],
                  "scan": [list(c) for c in zip(*scan)],
                  "d": d.tolist(),
                  "idx": rng.integers(0, PERIOD, size=(T, L)).tolist(),
                  "inf": (rng.random((T, L)) < 1 / 16).tolist()}
    return out


def _multiples(cd, g):
    """The host points k * gen of group g for k = 1..PERIOD."""
    gd = getattr(cd, g)
    E, P, out = gd.curve, gd.generator, []
    for _ in range(PERIOD):
        out.append(P if not out else E.add(out[-1], P))
    return out


def _msm_inputs(cd):
    """tests/test_more_curves.py:107-138's case: n = 33 SHA512 scalars (the
    second 0) and the points (i % 8 + 1) * gen."""
    E, gen = cd.g1.curve, cd.g1.generator
    ks = [hf.sha512_rng(cd.fr.mp, i) for i in range(MSM_N)]
    ks[1] = 0
    return ks, [E.mul((i % 8) + 1, gen) for i in range(MSM_N)]


def _digest(P) -> str:
    """SHA-256 of projective coordinates as plain int32 limbs (the port's
    32-bit limbs, the JAX package's 16-bit ones repacked)."""
    h = hashlib.sha256()
    for c in P:
        h.update(np.ascontiguousarray(np.asarray(c, dtype=np.int32)).tobytes())
    return h.hexdigest()


# -- the port's side ----------------------------------------------------------

def _field(F, vals):
    return F.from_ints(vals, "cpu")


def _host(F, P):
    return [F.to_ints(c) for c in P]


def test_field_ops_match_jax(golden):
    g = golden
    F = device_curve(CURVE).fq
    assert (F.n32, F.plain.n) == (24, 48)
    a, b = _field(F, g["a"]), _field(F, g["b"])
    for op in ("add", "sub", "mul"):
        assert F.to_ints(getattr(F, op)(a, b)) == g[op], op
    assert F.to_ints(F.inv(a)) == g["inv"]


@pytest.mark.parametrize("group", GROUPS)
def test_group_ops_and_scan_match_jax(golden, group):
    """K3's six ops (plain) on every lane, on the kernels' Fp branch with
    b3 = -3 (G1) or 12 (G2); then the scan at W = 4, c = 2."""
    g = golden[group]
    G = getattr(device_curve(CURVE), group)
    assert kernel_branch(G, "K3") == (1, {"g1": -3, "g2": 12}[group], None)
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


@pytest.mark.parametrize("group", GROUPS)
def test_insert_matches_insert_pallas3(golden, group):
    """insert_plain (K2's plain version) on two windows of the golden's
    digits and points against insert_pallas3's raw buckets."""
    dc = device_curve(CURVE)
    gold = golden[group]
    G = getattr(dc, group)
    pts = _multiples(dc.cd, group)
    idx = np.asarray(gold["idx"]).reshape(-1)
    x = _field(G.F, [pts[i][0] for i in idx]).reshape(G.F.el_shape + (T, L))
    y = _field(G.F, [pts[i][1] for i in idx]).reshape(G.F.el_shape + (T, L))
    inf = torch.tensor(gold["inf"], dtype=torch.bool)
    d = torch.tensor(gold["d"], dtype=torch.int32)
    raw = insert_plain(G, d, (x, y, G.F.neg(y), inf), B)
    assert _digest(raw) == gold["raw_sha256"]


def test_msm_matches_jax_and_the_host_oracle(golden):
    """The signed G1 MSM at n = 33, MsmConfig(c=4, lanes=8), with the
    377-bit scalars: the JAX package's affine point and the host
    oracle."""
    dc = device_curve(CURVE)
    cd, G = dc.cd, dc.g1
    ks, pts = _msm_inputs(cd)
    A = AffinePoint(G.F.from_ints([q[0] for q in pts], "cpu"),
                    G.F.from_ints([q[1] for q in pts], "cpu"),
                    torch.zeros(MSM_N, dtype=torch.bool))
    out = msm_pippenger(G, dc.fr.plain_from_ints(ks, "cpu"), A,
                        cd.fr.mp.bits, config=MsmConfig(c=4, lanes=8))
    Aff = G.to_affine(out)
    got = (G.F.to_host(Aff.x), G.F.to_host(Aff.y))
    assert list(got) == golden["msm"]["affine"]
    assert got == cd.g1.curve.msm(ks, pts)


def test_libraries_names_and_later_settings():
    """The 24-limb libraries are sources of csrc/, their launch counts
    carry the width, a product is 1176 mul.lo and 1152 mul.hi; both groups
    lie over Fq (no Fq2 is built), and every setting that once waited at
    24 limbs has its library: K5, K2m and K6, and K2, K2m and K5 over the
    SOS products, named with the width before the product."""
    dc = device_curve(CURVE)
    assert dc.fq2 is None and dc.g1.F is dc.fq and dc.g2.F is dc.fq
    for stem in ("fp_ops", "insert", "horner", "merge", "roofline"):
        assert (_build.CSRC / f"{_build.width_stem(stem, 24)}.cu").exists()
    for kind in ("insert", "merge"):
        for kmul in ("sos", "sos2"):
            stem = _build.width_stem(_build.kmul_stem(kind, kmul), 24)
            assert stem == f"{kind}_{kmul}_n24"
            assert (_build.CSRC / f"{stem}.cu").exists()
    assert "LFF_INSERT_V1_ENTRY" in (_build.CSRC / "insert_n24.cu").read_text()
    assert k3_stem(24, 1, -3) == k3_stem(24, 1, 12) == "group_ops_n24"
    assert _build.width_name("K3 scan g1", 24) == "K3 scan g1 n24"
    assert [_build.kmul_name(_build.width_name(f"{k} g1", 24), m)
            for k, m in (("K5", "cios"), ("K2m", "sos"), ("K6", "cios"),
                         ("K2", "sos2"))] == [
        "K5 g1 n24", "K2m g1 n24 sos", "K6 g1 n24", "K2 g1 n24 sos2"]
    assert imad_per_product("cios", 24) == {"lo": 1176, "hi": 1152}
    assert lane_words(dc.g1) == 24


def test_signed_digits_of_377_bit_scalars():
    """W = 48 signed 8-bit digits for BW6-761's Fr (377 bits, 12 32-bit
    limbs; 32 for BLS12-381's 255), each scalar equal to its digits'
    sum, r - 1 (the overflow cascade's worst case) among them."""
    dc = device_curve(CURVE)
    r = dc.r
    assert dig.num_signed_digits(r, 377, 8) == 48
    assert dig.num_signed_digits(device_curve("bls12_381").r, 255, 8) == 32
    ks = [0, 1, r - 1, r // 2, (1 << 376) + 12345] + [
        hf.sha512_rng(dc.cd.fr.mp, i) for i in range(11)]
    d = dig.signed_digits(dc.fr.plain_from_ints(ks, "cpu"), 8, 48)
    assert int(d.abs().max()) <= 128
    for j, k in enumerate(ks):
        assert sum(int(d[i, j]) << (8 * i) for i in range(48)) == k


# -- the golden, from the JAX package -----------------------------------------

def _write_golden() -> None:
    """tests/data/bw6_golden.json from the JAX package on the CPU: its
    field and group ops, the scan, insert_pallas3 through the reference
    executor (eager) and the MSM."""
    import jax.numpy as jnp

    from libff_tpu.curves.device import device_curve as jax_device_curve
    from libff_tpu.curves.group import AffinePoint as JA
    from libff_tpu.curves.group import JacobianPoint as JJ
    from libff_tpu.curves.group import ProjectivePoint as JP
    from libff_tpu.msm.pallas_insert3 import insert_pallas3
    from libff_tpu.msm.pippenger import MsmConfig as JaxMsmConfig
    from libff_tpu.msm.pippenger import _horner_complete
    from libff_tpu.msm.pippenger import msm_pippenger as jax_msm
    from libff_tpu_torch import convert

    jdc = jax_device_curve(CURVE)
    cd, JF = jdc.cd, jdc.fq
    g = _inputs(cd)

    def col(v):
        return JF.from_ints(v)

    def host(Pt):
        return [JF.to_ints(c) for c in Pt]

    a, b = col(g["a"]), col(g["b"])
    for op in ("add", "sub", "mul"):
        g[op] = JF.to_ints(getattr(JF, op)(a, b))
    g["inv"] = JF.to_ints(JF.inv(a))
    print("field ops", flush=True)
    for grp in GROUPS:
        JG, gg = getattr(jdc, grp), g[grp]
        assert JG.F is JF
        P, Q = (JJ(*(col(c) for c in gg[k])) for k in ("P", "Q"))
        A = JA(col(gg["A"][0]), col(gg["A"][1]), jnp.asarray(gg["A"][2]))
        PP, PQ = JP(*P), JP(*Q)
        gg["ops"] = {"padd": host(JG.padd(PP, PQ)),
                     "pmadd": host(JG.pmadd(PP, A)),
                     "pdbl": host(JG.pdbl(PP)), "add": host(JG.add(P, Q)),
                     "madd": host(JG.mixed_add(P, A)),
                     "dbl": host(JG.dbl(P))}
        Ts = JP(*(col(c) for c in gg["scan"]))
        gg["scan_sum"] = [JF.to_host(c) for c in
                          _horner_complete(JG, Ts, 2, direct="scan")]
        print(grp, "ops", flush=True)
        pts = _multiples(cd, grp)
        idx = np.asarray(gg["idx"]).reshape(-1)
        x = JF.from_ints([pts[i][0] for i in idx]).reshape(-1, T, L)
        y = JF.from_ints([pts[i][1] for i in idx]).reshape(-1, T, L)
        jpts = (x, y, JF.neg(y), jnp.asarray(gg["inf"]))
        d = jnp.asarray(np.asarray(gg["d"], dtype=np.int32))
        raw = insert_pallas3(JG, d, jpts, B, interpret="reference")
        gg["raw_sha256"] = _digest(
            [convert.field_to_torch(np.asarray(c), "cpu") for c in raw])
        print(grp, "insert", flush=True)
    ks, pts = _msm_inputs(cd)
    JG = jdc.g1
    JA_ = JA(JF.from_ints([q[0] for q in pts]),
             JF.from_ints([q[1] for q in pts]), jnp.zeros((MSM_N,), bool))
    R = jax_msm(JG, jdc.fr.plain_from_ints(ks), JA_, cd.fr.mp.bits,
                config=JaxMsmConfig(c=4, lanes=8))
    Aff = JG.to_affine(JJ(*(c[..., None] for c in R)))
    g["msm"] = {"affine": [JF.to_ints(Aff.x)[0], JF.to_ints(Aff.y)[0]]}
    assert tuple(g["msm"]["affine"]) == cd.g1.curve.msm(ks, pts)
    GOLDEN.write_text(json.dumps(g, indent=1) + "\n")


if __name__ == "__main__":
    _write_golden()
