"""The 12-limb lane merge, v1 insert and SOS products on the CPU:
BLS12-381 and BLS12-377, G1 and G2, held against the JAX package through
pinned goldens.

On CPU tensors every kernel runs its plain version, so these tests hold
the plain versions of the kernels this width added (K1's SOS and SOS2
products, K5, K2's fused merge K2m and the v1 insert K6) against the JAX
package's outputs at BLS12's 24 16-bit limbs, written once from
``libff_tpu`` into tests/data/bls12_merge_golden.json (``PYTHONPATH=.
python tests/test_torch_bls12_merge.py`` from the repository root writes
it again, about 40 minutes of eager JAX references).  No JAX program is
compiled here.

- ``PlainField.with_kmul``'s CIOS, SOS and SOS2 products on edge values
  and random elements against the JAX package's ``mul``, ``mul_sos`` and
  ``mul_sos2``, which the golden writer first holds to the host's x y
  R^-1 mod p;
- on G1 and G2 at W = 2 windows, T = 4 steps, L = 128 lanes and B = 8
  buckets (points among 32 generator multiples, some at infinity, random
  signed digits): ``insert_plain``'s raw buckets against
  ``insert_pallas3``'s (by their SHA-256, the raw buckets being large);
  ``merge_lanes_plain`` of them against ``insert_pallas3(merge=
  "kernel")``, which runs the JAX merge kernel ``_merge_lanes_kernel_call``
  through ``pallas_ref.reference_pallas_call`` (over CIOS on the second
  window, over SOS on G1's first and SOS2 on G2's); ``insert(merge=True)`` (over SOS2
  on G1's first window, SOS on G2's) against ``insert_pallas3(merge=True,
  kmul="sos")``, the golden writer holding the JAX package's totals
  equal under every product; on G1 ``insert_v1`` against
  ``insert_pallas``;
- one BLS12-381 G1 MSM with ``merge=True, kmul="sos"`` (c = 2, 128
  lanes) through the plain path against the JAX package's MSM already
  pinned in tests/data/bls12_golden.json.

All comparisons are exact.  The file holds twelve test items, fewer than
tests/test_mesh_msm.py's thirteen (xdist's loadfile scheduler queues
files by their item count).
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
from libff_tpu_torch.fields.fp import KMULS, to16, to32
from libff_tpu_torch.host import field as hf
from libff_tpu_torch.issue_rates import imad_per_product
from libff_tpu_torch.msm.insert import insert, insert_plain, insert_v1
from libff_tpu_torch.msm.merge import merge_lanes_plain
from libff_tpu_torch.msm.pippenger import MsmConfig, msm_pippenger

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data"
GOLDEN = DATA / "bls12_merge_golden.json"
CURVES = ["bls12_381", "bls12_377"]
GROUPS = ["g1", "g2"]
# the insert case: windows, steps, lanes (insert_pallas3 takes L % 128 ==
# 0), buckets (c = 4) and the generator multiples the points are drawn from
W, T, L, B, PERIOD = 2, 4, 128, 8, 32
MSM_N = 33


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


# -- the inputs, made from a seed and pinned in the golden --------------------

def _inputs(cd) -> dict:
    """Host inputs of one curve: Fp elements with edge values, and per
    group the insert case's signed digits (W, T, L), each step's point
    (an index into the generator multiples 1..PERIOD) and its infinity
    flag."""
    p = cd.q
    rng = np.random.default_rng(int(cd.q % 1000) + 3)
    R = (1 << 384) % p

    def rnd():
        return int.from_bytes(rng.bytes(48), "little") % p

    edges = [0, 1, 2, p - 1, p - 2, R, p - R, (p - 1) // 2]
    out = {"a": edges + [rnd() for _ in range(4)],
           "b": edges[::-1] + [rnd() for _ in range(4)]}
    for g in GROUPS:
        d = rng.integers(-B, B + 1, size=(W, T, L))
        d[rng.random((W, T, L)) < 0.2] = 0
        out[g] = {"d": d.tolist(),
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
    """tests/test_torch_bls12.py's MSM case: n = 33 SHA512 scalars (the
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

def _load(F, vals):
    if F.el_ndim == 1:
        return F.from_ints(vals, "cpu")
    return F.from_host_batch([tuple(v) for v in vals], "cpu")


def _host(F, P):
    if F.el_ndim == 1:
        return [F.to_ints(c.reshape(F.el_shape + (-1,))) for c in P]
    return [[list(v) for v in F.to_host_batch(c.reshape(F.el_shape + (-1,)))]
            for c in P]


def _case(dc, g, gold):
    """The port's insert inputs of golden case g: d (W, T, L) and (px, py,
    pneg, pinf) with coordinates (*el, T, L)."""
    G = getattr(dc, g)
    pts = _multiples(dc.cd, g)
    idx = np.asarray(gold["idx"]).reshape(-1)
    x = _load(G.F, [pts[i][0] for i in idx]).reshape(G.F.el_shape + (T, L))
    y = _load(G.F, [pts[i][1] for i in idx]).reshape(G.F.el_shape + (T, L))
    inf = torch.tensor(gold["inf"], dtype=torch.bool)
    d = torch.tensor(gold["d"], dtype=torch.int32)
    return G, d, (x, y, G.F.neg(y), inf)


@pytest.mark.parametrize("curve", CURVES)
def test_products_match_jax(golden, curve):
    """CIOS, SOS and SOS2 over 12-limb Fq (PlainField.with_kmul; K1's
    products at 12 limbs) against the JAX package's mul, mul_sos and
    mul_sos2 at 24 16-bit limbs."""
    g = golden[curve]
    F = device_curve(curve).fq
    a, b = (to16(F.from_ints(g[k], "cpu")) for k in ("a", "b"))
    for kmul in KMULS:
        got = F.to_ints(to32(F.plain.with_kmul(kmul).mul(a, b)))
        assert got == g["mul"][kmul], kmul


# the products of the K5 and K2m checks beside CIOS: each group meets
# both SOS products, one in K5, the other in K2m
SOS_CHECKS = {"g1": ("sos", "sos2"), "g2": ("sos2", "sos")}


def _window(P, w: int = 0):
    """Window w of (*el, W, B, L) buckets."""
    return [c[..., w:w + 1, :, :] for c in P]


@pytest.fixture(scope="module")
def raws(golden):
    """Per (curve, group): the port's insert inputs and insert_plain's raw
    buckets, held by their SHA-256 to insert_pallas3's."""
    out = {}
    for curve in CURVES:
        dc = device_curve(curve)
        for g in GROUPS:
            G, d, pts = _case(dc, g, golden[curve][g])
            raw = insert_plain(G, d, pts, B)
            assert _digest(raw) == golden[curve][g]["raw_sha256"], (curve, g)
            out[curve, g] = G, d, pts, raw
    return out


@pytest.mark.parametrize("curve", CURVES)
def test_k5_plain_matches_merge_kernel(golden, raws, curve):
    """On G1 and G2: merge_lanes_plain (K5) of the raw buckets against the
    JAX merge kernel's lane totals (insert_pallas3(merge="kernel")), over
    CIOS on the second window and over one SOS product on the first."""
    for g in GROUPS:
        G, _, _, raw = raws[curve, g]
        want = golden[curve][g]["merged"]
        for w, kmul in ((1, "cios"), (0, SOS_CHECKS[g][0])):
            got = merge_lanes_plain(G, type(raw)(*_window(raw, w)), kmul)
            assert _host(G.F, got) == [c[w * B:(w + 1) * B] for c in want], \
                (g, kmul)


@pytest.mark.parametrize("curve", CURVES)
def test_k2m_plain_matches_fused_kernel(golden, raws, curve):
    """On G1 and G2: insert(merge=True), K2m's plain path on the CPU, over
    the other SOS product, on the first window, against
    insert_pallas3(merge=True)'s lane totals."""
    for g in GROUPS:
        G, d, pts, _ = raws[curve, g]
        kmul = SOS_CHECKS[g][1]
        got = insert(G, d[:1].contiguous(), pts, B, merge=True, kmul=kmul)
        want = golden[curve][g]["fused"]
        assert _host(G.F, got) == [c[:B] for c in want], (g, kmul)


@pytest.mark.parametrize("curve", CURVES)
def test_k6_plain_matches_pallas_v1(golden, curve):
    """The v1 insert (K6's plain route) against insert_pallas, and its
    raw buckets equal K2's; refused on G2 as in the JAX package."""
    dc = device_curve(curve)
    gold = golden[curve]["g1"]
    G, d, pts = _case(dc, "g1", gold)
    assert _digest(insert_v1(G, d, pts, B)) == gold["v1_sha256"]
    assert gold["v1_sha256"] == gold["raw_sha256"]
    G2, d2, pts2 = _case(dc, "g2", golden[curve]["g2"])
    with pytest.raises(ValueError):
        insert_v1(G2, d2, pts2, B)


def test_msm_fused_sos_matches_pinned_msm():
    """The BLS12-381 G1 MSM of tests/test_torch_bls12.py (n = 33) with
    merge=True and kmul="sos" (the fused merge over SOS, which takes a
    multiple of 128 lanes: the 33 terms padded with 95 zero scalars), its
    affine point equal to the JAX package's pinned in
    tests/data/bls12_golden.json."""
    want = json.loads((DATA / "bls12_golden.json").read_text())
    dc = device_curve("bls12_381")
    G, cd = dc.g1, dc.cd
    ks, pts = _msm_inputs(cd)
    ks, pts = ks + [0] * (L - MSM_N), pts + pts[:1] * (L - MSM_N)
    A = AffinePoint(G.F.from_ints([q[0] for q in pts], "cpu"),
                    G.F.from_ints([q[1] for q in pts], "cpu"),
                    torch.zeros(L, dtype=torch.bool))
    out = msm_pippenger(G, dc.fr.plain_from_ints(ks, "cpu"), A,
                        cd.fr.mp.bits,
                        config=MsmConfig(c=2, lanes=L, merge=True,
                                         kmul="sos"))
    Aff = G.to_affine(out)
    assert [G.F.to_host(Aff.x), G.F.to_host(Aff.y)] == \
        want["bls12_381"]["msm"]["affine"]


@pytest.mark.parametrize("kind,kmul", [("merge", "cios"), ("insert", "sos"),
                                       ("merge", "sos2")])
def test_12_limb_libraries_and_launch_names(kind, kmul):
    """Each 12-limb library is a source of csrc/ (the product's stem, then
    the width's), its launch counts carry the width before the product,
    and the bounds count 12-limb SOS and SOS2 products."""
    stem = _build.width_stem(_build.kmul_stem(kind, kmul), 12)
    assert (_build.CSRC / f"{stem}.cu").exists()
    name = _build.kmul_name(_build.width_name(
        f"{'K5' if kind == 'merge' else 'K2m'} g2", 12), kmul)
    assert name == {"cios": "K5 g2 n12", "sos": "K2m g2 n12 sos",
                    "sos2": "K5 g2 n12 sos2"}[kmul]
    assert imad_per_product(kmul, 12) == (
        {"lo": 306, "hi": 294} if kmul == "sos2" else {"lo": 300, "hi": 288})


# -- the golden, from the JAX package -----------------------------------------

def _write_golden() -> None:
    """tests/data/bls12_merge_golden.json from the JAX package on the CPU:
    its products, and its insert and merge kernels through the reference
    executor (eager)."""
    import jax.numpy as jnp

    from libff_tpu.curves.device import device_curve as jax_device_curve
    from libff_tpu.msm.pallas_insert import insert_pallas
    from libff_tpu.msm.pallas_insert3 import insert_pallas3
    from libff_tpu_torch import convert

    out = {}
    for curve in CURVES:
        jdc = jax_device_curve(curve)
        cd = jdc.cd
        g = _inputs(cd)
        JF = jdc.fq
        a, b = JF.from_ints(g["a"]), JF.from_ints(g["b"])
        # on Montgomery forms x R, y R the product x R y R R^-1 = x y R
        host = [x * y % cd.q for x, y in zip(g["a"], g["b"])]
        g["mul"] = {}
        for kmul, fn in (("cios", JF.mul), ("sos", JF.mul_sos),
                         ("sos2", JF.mul_sos2)):
            g["mul"][kmul] = JF.to_ints(fn(a, b))
            # JAX's product equals the host's x y R^-1 mod p
            assert g["mul"][kmul] == host, (curve, kmul)
        for grp in GROUPS:
            JG = getattr(jdc, grp)
            gold = g[grp]
            pts = _multiples(cd, grp)
            idx = np.asarray(gold["idx"]).reshape(-1)
            if JG.F.el_ndim == 1:
                x = JG.F.from_ints([pts[i][0] for i in idx])
                y = JG.F.from_ints([pts[i][1] for i in idx])
            else:
                x = JG.F.from_host_batch([pts[i][0] for i in idx])
                y = JG.F.from_host_batch([pts[i][1] for i in idx])
            el = x.shape[:-1]
            jpts = (x.reshape(el + (T, L)), y.reshape(el + (T, L)),
                    JG.F.neg(y).reshape(el + (T, L)),
                    jnp.asarray(gold["inf"]))
            d = jnp.asarray(np.asarray(gold["d"], dtype=np.int32))
            nd = JG.F.el_ndim

            def port(P):
                return [convert.field_to_torch(np.asarray(c), "cpu", nd)
                        for c in P]

            def host_of(P):
                F = device_curve(curve).fq if nd == 1 else \
                    device_curve(curve).fq2
                return _host(F, port(P))

            raw = insert_pallas3(JG, d, jpts, B, interpret="reference")
            gold["raw_sha256"] = _digest(port(raw))
            gold["merged"] = host_of(insert_pallas3(
                JG, d, jpts, B, merge="kernel", interpret="reference"))
            gold["fused"] = host_of(insert_pallas3(
                JG, d, jpts, B, merge=True, kmul="sos", interpret="reference"))
            # every product gives the same totals in the JAX package too
            for merge, kmul in (("kernel", "sos2"), (True, "sos2")):
                assert host_of(insert_pallas3(
                    JG, d, jpts, B, merge=merge, kmul=kmul,
                    interpret="reference")) == gold["merged"], (merge, kmul)
            assert gold["fused"] == gold["merged"]
            if grp == "g1":
                gold["v1_sha256"] = _digest(port(insert_pallas(
                    JG, d, jpts, B, interpret="reference")))
            print(curve, grp, "done", flush=True)
        out[curve] = g
    GOLDEN.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    _write_golden()
