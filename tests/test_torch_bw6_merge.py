"""The 24-limb lane merge, v1 insert and SOS products on the CPU:
BW6-761's G1 (b3 = p - 3, the kernels' -3) and G2 over Fq (b3 = 12),
held against the JAX package through a pinned golden.

On CPU tensors every kernel runs its plain version, so these tests hold
the plain versions of the kernels this width added (K1's SOS and SOS2
products, K5, K2's fused merge K2m and the v1 insert K6) against the JAX
package's outputs at BW6-761's 48 16-bit limbs, written once from
``libff_tpu`` into tests/data/bw6_merge_golden.json (``PYTHONPATH=.
python tests/test_torch_bw6_merge.py`` from the repository root writes it
again, about 11 minutes of eager JAX references and the JAX MSM).  No JAX program is
compiled here.

- ``PlainField.with_kmul``'s CIOS, SOS and SOS2 products on edge values
  and random elements against the JAX package's ``mul``, ``mul_sos`` and
  ``mul_sos2``, which the golden writer first holds to the host's x y
  R^-1 mod p; and a host mirror of fp.cuh's 24-limb SOS and SOS2 rows
  (each chain two 12-limb blocks, the carry handed on in a register)
  against the same values;
- on G1 and G2 at W = 2 windows, T = 4 steps, L = 128 lanes and B = 8
  buckets (tests/data/bw6_golden.json's insert case, whose raw buckets
  ``insert_plain`` gives bit for bit, by their SHA-256):
  ``merge_lanes_plain`` of the raw buckets against the JAX merge kernel
  ``_merge_lanes_kernel_call`` through ``pallas_ref``'s reference
  executor (over CIOS on the second window, over SOS on G1's first and
  SOS2 on G2's); ``insert(merge=True)`` on the first window (over SOS2
  on G1, SOS on G2) against ``insert_pallas3(merge=True)`` over the
  other SOS product (every product gives the same totals); and
  ``insert_v1`` against ``insert_pallas``, which takes both groups, both
  lying over Fq;
- one BW6-761 G1 MSM of n = 33 scalars below 2^16 (num_bits = 16, so
  the plain Horner scan runs 5 windows, not 95) with MsmConfig(c=4,
  lanes=8, merge="kernel", kmul="sos") through the plain path against
  the JAX package's MSM of the same inputs, pinned in the golden (the
  fused merge needs a multiple of 128 lanes, and a plain merge of 128
  lanes at 24 limbs takes minutes here; K2m is held above);
- the 24-limb libraries of K5, K2m, K6 and K7b lone, their launch names
  and the bounds' product counts.

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

from libff_tpu_torch import _build, roofline
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group import AffinePoint
from libff_tpu_torch.fields.fp import KMULS, to16, to32
from libff_tpu_torch.issue_rates import imad_per_product
from libff_tpu_torch.msm.insert import insert, insert_plain, insert_v1
from libff_tpu_torch.msm.merge import merge_lanes_plain
from libff_tpu_torch.msm.pippenger import MsmConfig, msm_pippenger

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data"
GOLDEN = DATA / "bw6_merge_golden.json"
BW6_GOLDEN = DATA / "bw6_golden.json"
CURVE = "bw6_761"
GROUPS = ["g1", "g2"]
# tests/data/bw6_golden.json's insert case: windows, steps, lanes,
# buckets and the generator multiples its points are drawn from
W, T, L, B, PERIOD = 2, 4, 128, 8, 16
N32 = 24
MASK32 = (1 << 32) - 1
# the products of the K5 and K2m checks beside CIOS: each group meets
# both SOS products, one in K5, the other in K2m
SOS_CHECKS = {"g1": ("sos", "sos2"), "g2": ("sos2", "sos")}
# the MSM check: points, scalar bits
MSM_N, MSM_BITS = 33, 16


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.fixture(scope="module")
def bw6():
    return json.loads(BW6_GOLDEN.read_text())


def _inputs(cd) -> dict:
    """Host Fq elements of the product checks: edge values and random
    ones."""
    p = cd.q
    rng = np.random.default_rng(7613)
    R = (1 << 768) % p

    def rnd():
        return int.from_bytes(rng.bytes(96), "little") % p

    edges = [0, 1, 2, p - 1, p - 2, R, p - R, (p - 1) // 2]
    return {"a": edges + [rnd() for _ in range(4)],
            "b": edges[::-1] + [rnd() for _ in range(4)]}


def _multiples(cd, g):
    """The host points k * gen of group g for k = 1..PERIOD."""
    gd = getattr(cd, g)
    E, P, out = gd.curve, gd.generator, []
    for _ in range(PERIOD):
        out.append(P if not out else E.add(out[-1], P))
    return out


def _digest(P) -> str:
    """SHA-256 of projective coordinates as plain int32 limbs (the port's
    32-bit limbs, the JAX package's 16-bit ones repacked)."""
    h = hashlib.sha256()
    for c in P:
        h.update(np.ascontiguousarray(np.asarray(c, dtype=np.int32)).tobytes())
    return h.hexdigest()


def _host(F, P):
    """Each coordinate's plain values, rows (w, b) in order."""
    return [F.to_ints(c.reshape(N32, -1)) for c in P]


def _case(dc, g, gold):
    """The port's insert inputs of bw6_golden.json's case g: d (W, T, L)
    and (px, py, pneg, pinf) with coordinates (24, T, L)."""
    G = getattr(dc, g)
    pts = _multiples(dc.cd, g)
    idx = np.asarray(gold["idx"]).reshape(-1)
    x = G.F.from_ints([pts[i][0] for i in idx], "cpu").reshape(N32, T, L)
    y = G.F.from_ints([pts[i][1] for i in idx], "cpu").reshape(N32, T, L)
    inf = torch.tensor(gold["inf"], dtype=torch.bool)
    d = torch.tensor(gold["d"], dtype=torch.int32)
    return G, d, (x, y, G.F.neg(y), inf)


def _window(P, w: int = 0):
    """Window w of (24, W, B, L) buckets."""
    return type(P)(*(c[:, w:w + 1] for c in P))


@pytest.fixture(scope="module")
def raws(bw6):
    """Per group: the port's insert inputs and insert_plain's raw buckets,
    held by their SHA-256 to insert_pallas3's (bw6_golden.json)."""
    dc = device_curve(CURVE)
    out = {}
    for g in GROUPS:
        G, d, pts = _case(dc, g, bw6[g])
        raw = insert_plain(G, d, pts, B)
        assert _digest(raw) == bw6[g]["raw_sha256"], g
        out[g] = G, d, pts, raw
    return out


# -- the products -------------------------------------------------------------

def test_products_match_jax(golden):
    """CIOS, SOS and SOS2 over 24-limb Fq (PlainField.with_kmul; K1's
    products at 24 limbs) against the JAX package's mul, mul_sos and
    mul_sos2 at 48 16-bit limbs."""
    F = device_curve(CURVE).fq
    a, b = (to16(F.from_ints(golden[k], "cpu")) for k in ("a", "b"))
    for kmul in KMULS:
        got = F.to_ints(to32(F.plain.with_kmul(kmul).mul(a, b)))
        assert got == golden["mul"][kmul], kmul


def _words(v: int) -> list[int]:
    return [(v >> (32 * i)) & MASK32 for i in range(N32)]


def _mad12(t, at, x, y, cin, hi):
    """fp.cuh's mad_lo12 / mad_hi12: t[at..at+11] += lo (hi) of x y[j],
    the carry flag set from cin first; returns the carry out."""
    flag = cin
    for j in range(12):
        prod = x * y[j]
        s = t[at + j] + ((prod >> 32) if hi else (prod & MASK32)) + flag
        t[at + j], flag = s & MASK32, s >> 32
    return flag


def _mad_row(t, at, x, y, cin):
    """fp.cuh's mad_row at N = 24: mad_lo_row (two 12-limb blocks, then
    word at + 24 takes cin and the blocks' carry) and mad_hi_row (two
    blocks from word at + 1); returns the carry owed to word at + 25."""
    k = _mad12(t, at, x, y[:12], 0, False)
    k = _mad12(t, at + 12, x, y[12:], k, False)
    s = t[at + 24] + cin + k
    t[at + 24], c = s & MASK32, s >> 32
    k = _mad12(t, at + 1, x, y[:12], 0, True)
    return c + _mad12(t, at + 13, x, y[12:], k, True)


def sos_mirror(a: int, b: int, p: int, inv: int, inv_hi: int,
               block2: bool) -> int:
    """fp.cuh's 24-limb mul_sos (block2 False) or mul_sos2 as its 32-bit
    words go: full_product's rows, then sos_redc's waves and reduce_once;
    -p^-1 mod 2^64 = inv + inv_hi 2^32."""
    t = [0] * (2 * N32 + 1)
    aw, bw, pw = _words(a), _words(b), _words(p)
    c = 0
    for i in range(N32):
        c = _mad_row(t, i, aw[i], bw, c)
    t[2 * N32] = c
    c = 0
    for i in range(0, N32, 2 if block2 else 1):
        if block2:
            m0 = t[i] * inv & MASK32
            m1 = ((t[i] * inv >> 32) + t[i] * inv_hi + t[i + 1] * inv) & MASK32
            c = _mad_row(t, i, m0, pw, c)
            c = _mad_row(t, i + 1, m1, pw, c)
        else:
            c = _mad_row(t, i, t[i] * inv & MASK32, pw, c)
    top = t[2 * N32] + c
    r = sum(w << (32 * i) for i, w in enumerate(t[N32:2 * N32]))
    assert r + (top << 768) < 2 * p
    borrow = int(r < p)                 # of reduce_once's r - p
    return (r - p) % (1 << 768) if top == borrow else r


def test_sos_rows_in_blocks_match_jax(golden):
    """The host mirror of fp.cuh's 24-limb SOS and SOS2 (sos_mirror), on
    the Montgomery forms of the golden's a and b, against the JAX
    package's mul_sos and mul_sos2: the carries handed from block to
    block and wave to wave lose nothing."""
    F = device_curve(CURVE).fq
    p, R = F.p, 1 << 768
    inv64 = (-pow(p, -1, 1 << 64)) % (1 << 64)
    for kmul, block2 in (("sos", False), ("sos2", True)):
        got = [sos_mirror(x * R % p, y * R % p, p, inv64 & MASK32,
                          inv64 >> 32, block2) * pow(R, -1, p) % p
               for x, y in zip(golden["a"], golden["b"])]
        assert got == golden["mul"][kmul], kmul


# -- K5, K2m, K6 ----------------------------------------------------------------

@pytest.mark.parametrize("group", GROUPS)
def test_k5_plain_matches_merge_kernel(golden, raws, group):
    """merge_lanes_plain (K5) of the raw buckets against the JAX merge
    kernel's lane totals (_merge_lanes_kernel_call), over CIOS on the
    second window and over one SOS product on the first."""
    G, _, _, raw = raws[group]
    want = golden[group]["merged"]
    for w, kmul in ((1, "cios"), (0, SOS_CHECKS[group][0])):
        got = merge_lanes_plain(G, _window(raw, w), kmul)
        assert _host(G.F, got) == [c[w * B:(w + 1) * B] for c in want], kmul


@pytest.mark.parametrize("group", GROUPS)
def test_k2m_plain_matches_fused_kernel(golden, raws, group):
    """insert(merge=True), K2m's plain path on the CPU, over the other
    SOS product, on the first window, against insert_pallas3(merge=True)'s
    lane totals."""
    G, d, pts, _ = raws[group]
    kmul = SOS_CHECKS[group][1]
    got = insert(G, d[:1].contiguous(), pts, B, merge=True, kmul=kmul)
    assert _host(G.F, got) == golden[group]["fused"], kmul


@pytest.mark.parametrize("group", GROUPS)
def test_k6_plain_matches_pallas_v1(golden, raws, group):
    """The v1 insert (K6's plain route) against insert_pallas on both
    groups (both over Fq), its raw buckets equal to K2's."""
    G, d, pts, raw = raws[group]
    assert _digest(insert_v1(G, d, pts, B)) == golden[group]["v1_sha256"]
    assert golden[group]["v1_sha256"] == _digest(raw)


def _msm_inputs(cd):
    """tests/test_torch_bw6.py's MSM case with its scalars cut to MSM_BITS
    bits: n = 33 SHA512 scalars mod 2^16 (the second 0) and the points
    (i % 8 + 1) * gen."""
    from libff_tpu_torch.host import field as hf

    E, gen = cd.g1.curve, cd.g1.generator
    ks = [hf.sha512_rng(cd.fr.mp, i) % (1 << MSM_BITS) for i in range(MSM_N)]
    ks[1] = 0
    return ks, [E.mul((i % 8) + 1, gen) for i in range(MSM_N)]


def test_msm_merge_sos_matches_pinned_msm(golden):
    """A G1 MSM (n = 33 scalars of 16 bits, c = 4, 8 lanes) with
    merge="kernel" and kmul="sos": K2 and K5 over SOS on the plain path,
    its affine point equal to the JAX package's pinned in the golden."""
    dc = device_curve(CURVE)
    G, cd = dc.g1, dc.cd
    ks, pts = _msm_inputs(cd)
    A = AffinePoint(G.F.from_ints([q[0] for q in pts], "cpu"),
                    G.F.from_ints([q[1] for q in pts], "cpu"),
                    torch.zeros(MSM_N, dtype=torch.bool))
    out = msm_pippenger(G, dc.fr.plain_from_ints(ks, "cpu"), A, MSM_BITS,
                        config=MsmConfig(c=4, lanes=8, merge="kernel",
                                         kmul="sos"))
    Aff = G.to_affine(out)
    assert [G.F.to_host(Aff.x), G.F.to_host(Aff.y)] == golden["msm"]


@pytest.mark.parametrize("kind,kmul", [("merge", "cios"), ("insert", "sos"),
                                       ("merge", "sos2")])
def test_24_limb_libraries_and_launch_names(kind, kmul):
    """Each 24-limb library of K5 and K2m is a source of csrc/ (the
    product's stem, then the width's), its launch counts carry the width
    before the product, K6 and K7b lone have theirs, and the bounds count
    24-limb SOS and SOS2 products."""
    stem = _build.width_stem(_build.kmul_stem(kind, kmul), N32)
    assert (_build.CSRC / f"{stem}.cu").exists()
    name = _build.kmul_name(_build.width_name(
        f"{'K5' if kind == 'merge' else 'K2m'} g1", N32), kmul)
    assert name == {"cios": "K5 g1 n24", "sos": "K2m g1 n24 sos",
                    "sos2": "K5 g1 n24 sos2"}[kmul]
    assert _build.width_name("K6 g1", N32) == "K6 g1 n24"
    assert "insert_v1" in (_build.CSRC / "insert_n24.cu").read_text()
    assert roofline.LONE_PRODUCTS[N32] == ("cios",)
    assert roofline.lone_name(N32) == "K7b lone n24"
    assert (_build.CSRC / "roofline_n24.cu").exists()
    assert imad_per_product(kmul, N32) == (
        {"lo": 1188, "hi": 1164} if kmul == "sos2"
        else {"lo": 1176, "hi": 1152})


# -- the golden, from the JAX package -----------------------------------------

def _write_golden() -> None:
    """tests/data/bw6_merge_golden.json from the JAX package on the CPU:
    its products, and its merge, fused insert and v1 insert kernels
    through the reference executor (eager).  The merge kernel runs on the
    raw buckets of bw6_golden.json's insert case, which insert_plain gives
    bit for bit (held by their SHA-256).  Last, its MSM of the 16-bit
    scalars (MsmConfig(c=4, lanes=8)), held to the host's."""
    import time

    import jax.numpy as jnp

    from libff_tpu.curves.device import device_curve as jax_device_curve
    from libff_tpu.curves.group import AffinePoint as JA
    from libff_tpu.curves.group import JacobianPoint as JJ
    from libff_tpu.msm.pallas_insert import insert_pallas
    from libff_tpu.msm.pallas_insert3 import (_merge_lanes_kernel_call,
                                              insert_pallas3)
    from libff_tpu.msm.pippenger import MsmConfig as JaxMsmConfig
    from libff_tpu.msm.pippenger import msm_pippenger as jax_msm
    from libff_tpu_torch import convert

    t0 = time.time()
    bw6 = json.loads(BW6_GOLDEN.read_text())
    jdc = jax_device_curve(CURVE)
    cd, JF = jdc.cd, jdc.fq
    F = device_curve(CURVE).fq
    out = _inputs(cd)
    a, b = JF.from_ints(out["a"]), JF.from_ints(out["b"])
    host = [x * y % cd.q for x, y in zip(out["a"], out["b"])]
    out["mul"] = {}
    for kmul, fn in (("cios", JF.mul), ("sos", JF.mul_sos),
                     ("sos2", JF.mul_sos2)):
        out["mul"][kmul] = JF.to_ints(fn(a, b))
        # JAX's product equals the host's x y R^-1 mod p
        assert out["mul"][kmul] == host, kmul

    def port(P):
        return [convert.field_to_torch(np.asarray(c), "cpu") for c in P]

    def lane0(res):
        """_merge_lanes_kernel_call's (W, 24, B, 1, 128) packed rows: lane
        0, as the port's (24, W, B) 32-bit limbs (a packed row is two
        16-bit limbs, the port's 32-bit limb)."""
        return [torch.from_numpy(np.ascontiguousarray(
            np.asarray(c)[:, :, :, 0, 0].transpose(1, 0, 2)).view(np.int32))
            for c in res]

    print("products", time.time() - t0, flush=True)
    dc = device_curve(CURVE)
    for grp in GROUPS:
        JG, gold = getattr(jdc, grp), {}
        G, d, pts = _case(dc, grp, bw6[grp])
        raw = insert_plain(G, d, pts, B)
        assert _digest(raw) == bw6[grp]["raw_sha256"], grp
        # the packed (W, 24, B, Ls, 128) rows of insert_pallas3's raw output
        res = [jnp.asarray(c.permute(1, 0, 2, 3).contiguous().numpy()
                           .view(np.uint32).reshape(W, N32, B, L // 128, 128))
               for c in raw]
        merged = {}
        for kmul in ("cios", SOS_CHECKS[grp][0]):
            merged[kmul] = _host(F, lane0(_merge_lanes_kernel_call(
                JG, res, W, N32, B, L // 128, True, 1, 2 * N32, None,
                "reference", kmul)))
            print(grp, "merge", kmul, time.time() - t0, flush=True)
        assert merged["cios"] == merged[SOS_CHECKS[grp][0]]
        gold["merged"] = merged["cios"]
        jpts = tuple(JF.from_ints(v).reshape(-1, T, L)
                     for v in _host(F, pts[:3])) + (
            jnp.asarray(bw6[grp]["inf"]),)
        jd = jnp.asarray(np.asarray(bw6[grp]["d"], dtype=np.int32))
        gold["fused"] = _host(F, port(insert_pallas3(
            JG, jd[:1], jpts, B, merge=True, kmul=SOS_CHECKS[grp][0],
            interpret="reference")))
        assert gold["fused"] == [c[:B] for c in gold["merged"]]
        print(grp, "fused", time.time() - t0, flush=True)
        gold["v1_sha256"] = _digest(port(insert_pallas(
            JG, jd, jpts, B, interpret="reference")))
        assert gold["v1_sha256"] == bw6[grp]["raw_sha256"]
        print(grp, "v1", time.time() - t0, flush=True)
        out[grp] = gold
    ks, mpts = _msm_inputs(cd)
    JG = jdc.g1
    R = jax_msm(JG, jdc.fr.plain_from_ints(ks),
                JA(JF.from_ints([q[0] for q in mpts]),
                   JF.from_ints([q[1] for q in mpts]),
                   jnp.zeros((MSM_N,), bool)),
                MSM_BITS, config=JaxMsmConfig(c=4, lanes=8))
    Aff = JG.to_affine(JJ(*(c[..., None] for c in R)))
    out["msm"] = [JF.to_ints(Aff.x)[0], JF.to_ints(Aff.y)[0]]
    assert tuple(out["msm"]) == cd.g1.curve.msm(ks, mpts)
    print("msm", time.time() - t0, flush=True)
    GOLDEN.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    _write_golden()
