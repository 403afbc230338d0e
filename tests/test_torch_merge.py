"""The lane merge on the CPU: kernel K5, K2's fused merge and the v1
insert K6 (their plain versions), and the MSM under every engine and
merge setting.

K5: ``merge_lanes_plain`` of the JAX package's raw buckets must equal
``insert_pallas3(..., merge="kernel")``; K2's fused branch: the port's
``insert(..., merge=True)`` must equal ``insert_pallas3(..., merge=True)``;
K6: ``insert_v1`` must equal ``insert_pallas``.  The JAX kernels' bodies
run through ``interpret="reference"``, eagerly, on the toy contexts of
tests/test_pallas_interpret.py: G1 at L = 128, G2 at L = 256 (Ls = 2, so
the merge's halving stage runs), cut to their first windows to keep the
eager JAX merge cheap.  At alt_bn128 width on a few elements the merge
must equal the halving loop of ``pippenger._reduce_buckets``.  All
comparisons are exact, limb for limb after the 16/32-bit repack.
"""

import numpy as np
import pytest
import torch

from libff_tpu.msm.pallas_insert import insert_pallas
from libff_tpu.msm.pallas_insert3 import insert_pallas3
from libff_tpu_torch import _build, convert, tune_merge
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group import AffinePoint, Group, ProjectivePoint
from libff_tpu_torch.fields.fp import PrimeField
from libff_tpu_torch.fields.tower import ExtField
from libff_tpu_torch.msm.insert import insert, insert_v1
from libff_tpu_torch.msm.merge import (PLAIN_WINDOWS, merge_lanes,
                                       merge_lanes_plain)
from libff_tpu_torch.msm.pippenger import (MsmConfig, _halve_lanes,
                                           _reduce_buckets, msm_pippenger,
                                           window_totals_v1)
from tests.test_pallas_interpret import (NUM_BITS, P_TOY,  # noqa: F401
                                         g1ctx, g2ctx, g2ctx_ls2)

torch.set_num_threads(1)

# windows of each toy context that the JAX merges run on
WINDOWS = {"g1": 1, "g2": 1}


def _port_group(JG) -> Group:
    """The port's Group over the JAX toy group's host field and GroupDef."""
    Fp = PrimeField(P_TOY, name="toy_Fp")
    F = Fp if JG.F.el_ndim == 1 else ExtField(Fp, JG.F.h)
    return Group(F, JG.gdef)


def _to_torch(G, jax_point) -> ProjectivePoint:
    return ProjectivePoint(*(convert.field_to_torch(np.asarray(c), "cpu",
                                                    G.F.el_ndim)
                             for c in jax_point))


def _equal(got: ProjectivePoint, want: ProjectivePoint):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)


class _Case:
    """One toy context cut to its first windows, in both packages, with
    the JAX kernels' outputs computed once each."""

    def __init__(self, ctx, windows: int):
        JG, _, d, pts, B, _ = ctx
        self.JG, self.G, self.B = JG, _port_group(JG), B
        self.jd, self.jpts = d[:windows], pts
        nd = self.G.F.el_ndim
        self.d = torch.from_numpy(np.array(self.jd))
        self.pts = tuple(convert.field_to_torch(np.asarray(c), "cpu", nd)
                         for c in pts[:3]) + (
            torch.from_numpy(np.array(pts[3])),)
        self._jax = {}

    def jax_insert(self, merge):
        if merge not in self._jax:
            self._jax[merge] = _to_torch(self.G, insert_pallas3(
                self.JG, self.jd, self.jpts, self.B, merge=merge,
                interpret="reference"))
        return self._jax[merge]


@pytest.fixture(scope="module")
def cases(g1ctx, g2ctx_ls2):  # noqa: F811
    return {"g1": _Case(g1ctx, WINDOWS["g1"]),
            "g2": _Case(g2ctx_ls2, WINDOWS["g2"])}


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_merge_lanes_plain_matches_merge_kernel(cases, group):
    """K5's plain version over the JAX package's raw buckets against its
    second Pallas kernel (_merge_kernel)."""
    c = cases[group]
    raw = c.jax_insert(False)
    assert raw.z.shape[-1] == {"g1": 128, "g2": 256}[group]
    want = c.jax_insert("kernel")
    _equal(merge_lanes_plain(c.G, raw), want)
    _equal(merge_lanes(c.G, raw), want)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fused_insert_matches_fused_kernel(cases, group):
    """K2's fused branch (its plain version on the CPU) against the JAX
    insert kernel's merge=True body."""
    c = cases[group]
    got = insert(c.G, c.d, c.pts, c.B, merge=True)
    assert got.z.shape[-1] == 1
    _equal(got, c.jax_insert(True))


def test_insert_v1_matches_pallas_v1(cases):
    c = cases["g1"]
    want = _to_torch(c.G, insert_pallas(c.JG, c.jd, c.jpts, c.B,
                                        interpret="reference"))
    _equal(insert_v1(c.G, c.d, c.pts, c.B), want)
    _equal(want, c.jax_insert(False))
    _equal(window_totals_v1(c.G, c.d, c.pts, c.B),
           _reduce_buckets(c.G, c.jax_insert(False), c.B))


def test_insert_v1_refuses_g2(cases):
    c = cases["g2"]
    with pytest.raises(ValueError):
        insert_v1(c.G, c.d, c.pts, c.B)


def _random_buckets(G, rng, shape) -> ProjectivePoint:
    """Projective coordinates of random canonical field elements: the
    complete add's formula does not need points on the curve."""
    F, n = G.F, int(np.prod(shape))
    p = F.prime_field.p

    def coord():
        ints = [int.from_bytes(rng.bytes(32), "little") % p
                for _ in range(n * (2 if F.el_ndim == 2 else 1))]
        if F.el_ndim == 1:
            t = F.from_ints(ints, "cpu")
        else:
            t = F.from_host_batch(list(zip(ints[::2], ints[1::2])), "cpu")
        return t.reshape(F.el_shape + shape)

    return ProjectivePoint(coord(), coord(), coord())


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("L", [1, 2, 8])
def test_merge_equals_reduce_halving_loop(group, L):
    """At alt_bn128 width (W = 2, B = 4): the merge's order is the halving
    loop of _reduce_buckets, so merge=False, "kernel" and True give the
    same buckets; some lanes hold the identity."""
    G = getattr(device_curve("alt_bn128"), group)
    P = _random_buckets(G, np.random.default_rng(81 + L), (2, 4, L))
    ident = G.proj_zero((2, 4, L), "cpu")
    ident_lanes = torch.from_numpy(
        np.random.default_rng(L).random((2, 4, L)) < 0.25)
    P = G.select(ident_lanes, ident, P)
    want = _halve_lanes(G, P)
    assert want.z.shape[-1] == 1
    _equal(merge_lanes_plain(G, P), want)


def test_merge_plain_takes_windows_in_chunks():
    """Past PLAIN_WINDOWS windows the plain merge runs them in chunks and
    still gives the halving loop's buckets, window for window."""
    G = device_curve("alt_bn128").g1
    shape = (PLAIN_WINDOWS + 1, 2, 4)
    P = _random_buckets(G, np.random.default_rng(83), shape)
    _equal(merge_lanes_plain(G, P), _halve_lanes(G, P))


# -- the MSM under every engine and merge setting -------------------------

CONFIGS = [("auto", False), ("auto", "kernel"), ("auto", True),
           ("pallas3", False), ("pallas3", "kernel"), ("pallas3", True),
           ("pallas", False)]
C = 4
LANES = 128


def _toy_msm_inputs(G, E, gen, n, seed):
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(0, 1 << NUM_BITS, size=n)]
    pts = [E.mul(int(k), gen) for k in rng.integers(1, 1 << 16, size=n)]
    inf = np.zeros(n, dtype=bool)
    inf[n // 3] = True
    limbs = np.zeros((4, n), dtype=np.uint32)
    limbs[0] = ks
    load = (G.F.from_ints if G.F.el_ndim == 1 else G.F.from_host_batch)
    A = AffinePoint(load([p[0] for p in pts], "cpu"),
                    load([p[1] for p in pts], "cpu"), torch.from_numpy(inf))
    want = E.msm([k for k, i in zip(ks, inf) if not i],
                 [p for p, i in zip(pts, inf) if not i])
    return convert.field_to_torch(limbs, "cpu"), A, want


@pytest.fixture(scope="module")
def msm_results(cases):
    """The toy curve's host MSM value and, per config, the Jacobian limbs
    and the affine result of the port's MSM (256 points, 128 lanes)."""
    G = cases["g1"].G
    s, A, want = _toy_msm_inputs(G, G.gdef.curve, G.gdef.generator, 256, 83)
    res = {}
    for engine, merge in CONFIGS:
        R = msm_pippenger(G, s, A, NUM_BITS, config=MsmConfig(
            c=C, lanes=LANES, engine=engine, merge=merge))
        aff = G.to_affine(R)
        res[(engine, merge)] = (R, None if bool(aff.inf) else (
            G.F.to_host(aff.x), G.F.to_host(aff.y)))
    return want, res


@pytest.mark.parametrize("engine,merge", CONFIGS)
def test_msm_every_config_matches_host(msm_results, engine, merge):
    """The same Jacobian limbs under every engine and merge setting, and
    the host MSM's value."""
    want, res = msm_results
    R, host = res[(engine, merge)]
    assert host == want
    for g, w in zip(R, res[("auto", False)][0]):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def small_msm(cases):
    c = cases["g1"]
    s, A, _ = _toy_msm_inputs(c.G, c.G.gdef.curve, c.G.gdef.generator, 8, 84)
    return c.G, s, A


@pytest.mark.parametrize("engine,merge,lanes,error", [
    ("xla", False, 8, NotImplementedError),
    ("nope", False, 8, ValueError),
    ("auto", "fused", 8, ValueError),
    ("auto", 1, 8, ValueError),
    ("pallas", "kernel", 8, ValueError),
    ("pallas", True, 8, ValueError),
    ("auto", True, 8, ValueError),        # the fused merge needs L % 128
    ("pallas3", True, 8, ValueError),
])
def test_config_checks(small_msm, engine, merge, lanes, error):
    G, s, A = small_msm
    with pytest.raises(error):
        msm_pippenger(G, s, A, NUM_BITS, config=MsmConfig(
            c=C, lanes=lanes, engine=engine, merge=merge))


def test_pallas_engine_refuses_g2(cases):
    c = cases["g2"]
    s, A, _ = _toy_msm_inputs(c.G, c.G.gdef.curve, c.G.gdef.generator, 8, 85)
    with pytest.raises(ValueError):
        msm_pippenger(c.G, s, A, NUM_BITS,
                      config=MsmConfig(c=C, lanes=8, engine="pallas"))


@pytest.mark.parametrize("case", ["lanes", "shape", "dtype", "device"])
def test_k5_wrapper_rejects(case):
    G = device_curve("alt_bn128").g1
    P = _random_buckets(G, np.random.default_rng(86), (2, 4, 8))
    if case == "lanes":
        P = ProjectivePoint(*(a[..., :6] for a in P))
    elif case == "shape":
        P = ProjectivePoint(P.x, P.y, P.z[..., :4])
    elif case == "dtype":
        P = ProjectivePoint(P.x.to(torch.int64), P.y, P.z)
    else:
        P = ProjectivePoint(*(a.to("meta") for a in P))
    with pytest.raises(ValueError):
        merge_lanes(G, P)


# -- the kernel's schedule ------------------------------------------------

def _levels_tree(L: int):
    """Lane 0's total as nested pairs (P_l, P_(l+h)) over the levels h =
    L/2 .. 1 of merge_lanes_plain; leaves are lane numbers."""
    lanes = list(range(L))
    h = L // 2
    while h >= 1:
        lanes[:h] = [(lanes[l], lanes[l + h]) for l in range(h)]
        h //= 2
    return lanes[0]


def _kernel_tree(L: int, row: int):
    """csrc/merge.cuh's merge_kernel on one warp of `row` elements (32 on
    G1 and the one-thread G2 body, 16 pairs on G2 over CIOS), step for
    step, with an add that records its operands: the depth-first walk over
    each element's lanes t + r j with its slots, then the butterfly of
    __shfl_down_sync (a source past the warp returns the caller's own
    value).  Returns element 0's total and the most slots an element
    held."""
    r = min(row, L)
    t = [u if u < r else 0 for u in range(row)]
    m = L // r
    half = m // 2
    bits = half.bit_length() - 1 if half > 1 else 0
    in_steps = m - 1
    steps = in_steps + r.bit_length() - 1
    c = [t[u] for u in range(row)] if m == 1 else [None] * row
    slots = [{} for _ in range(row)]
    i = k = 0
    fresh = True
    for step in range(steps):
        if step < in_steps:
            if fresh:
                j = int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
                a = [t[u] + r * j for u in range(row)]
                b = [t[u] + r * (j + half) for u in range(row)]
                k = 0
            else:
                a = [slots[u][k] for u in range(row)]
                b = c
                k += 1
        else:
            h = r >> (step - in_steps + 1)
            a = c
            b = [c[u + h] if u + h < row else c[u] for u in range(row)]
        c = [(a[u], b[u]) for u in range(row)]
        if step < in_steps:
            fresh = (i >> k) & 1 == 0
            if fresh:
                if i + 1 < half:
                    for u in range(row):
                        slots[u][k] = c[u]
                i += 1
    return c[0], max(len(s) for s in slots)


@pytest.mark.parametrize("row", [32, 16])
@pytest.mark.parametrize("L", [1 << e for e in range(12)])
def test_kernel_schedule_forms_the_levels_pairs(L, row):
    """The kernel's schedule pairs the same lanes in the same operand
    order as the levels, at every lane count from 1 to 2048, and holds at
    most log2(m) - 1 partials a thread (m = L / min(row, L) lanes), the
    slots its launch sizes shared memory for."""
    got, held = _kernel_tree(L, row)
    assert got == _levels_tree(L)
    m = L // min(row, L)
    assert held == (m.bit_length() - 2 if m > 2 else 0)


@pytest.mark.parametrize("name", tune_merge.TUNABLES)
def test_tune_merge_macros_are_open_in_the_header(name):
    """Each macro tune_merge sets by -D is one that merge.cuh defines
    under #ifndef, so a variant build really changes it."""
    head = (_build.CSRC / "merge.cuh").read_text()
    assert f"#ifndef {name}\n#define {name} " in head
