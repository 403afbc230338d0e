"""K3's 12-limb redesigns on the CPU: the G1 pair schedule, the scan's
two-accumulator product and the lane halving's in-place reads.

- ``group_op_split_plain`` (csrc/split_ops.cuh's schedule of padd and
  pmadd on two threads an element, step by step) against
  ``group_op_plain`` on the toy curve of tests/test_pallas_interpret.py
  (p = 65539, b = 11, b3 = 33: the addition chain of a b3 that is
  neither 12 nor 3) with ``workload.k3_inputs``' kinds of edge lanes (P =
  0, Q = 0, Q = P, Q = -P, Q = P rescaled, Q at infinity);
- the same schedule at 12 limbs on BLS12-381 and BLS12-377 against the
  pinned tests/data/bls12_golden.json (the JAX package's outputs);
- ``roofline.mul_eo_words`` (csrc/chain_mul.cuh's product word by word,
  its dropped carries checked) against the CIOS product on 0, 1, p - 1,
  R mod p and random 12-limb values;
- ``group_ops.kernel_reads`` (the words K3 reads for a coordinate view,
  from ``input_layout``) on the two halves of a bucket array at every
  halving level, against the halves copied, on the toy curve (Fp) and on
  alt_bn128 G2 (Fq2).

All comparisons are exact.  No JAX program is compiled: the goldens are
pinned.
"""

import json
import pathlib
import random

import numpy as np
import pytest
import torch

from libff_tpu_torch.curves.curvedef import GroupDef
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.curves.group import Group
from libff_tpu_torch.curves.group_ops import (PAIR_OPS, group_op_split_plain,
                                              group_op_plain, input_layout,
                                              kernel_reads)
from libff_tpu_torch.fields.fp import PrimeField
from libff_tpu_torch.host import ec as hec
from libff_tpu_torch.host import field as hf
from libff_tpu_torch.roofline import mul_eo_words
from tests.test_pallas_interpret import B_TOY, GEN_TOY, N_TOY, P_TOY

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "data" / "bls12_golden.json"
CURVES12 = ["bls12_381", "bls12_377"]


@pytest.fixture(scope="module")
def toy():
    Fh = hf.Fp(P_TOY, name="toy_Fp")
    E = hec.WeierstrassCurve(Fh, 0, B_TOY, name="toy_E")
    gdef = GroupDef(name="toy", curve=E, generator=GEN_TOY, cofactor=1,
                    order=N_TOY, wnaf_window_table=(4,),
                    fixed_base_exp_window_table=(1,))
    return Group(PrimeField(P_TOY, name="toy_Fp"), gdef)


def _toy_inputs(G, n, rng):
    """k3_inputs' lanes on the toy curve (whose 2-limb p is too short for
    workload.rand_elements): random coordinates, then P = 0, Q = 0, Q = P,
    Q = -P, Q = P scaled by w, and for pmadd the affine Q = (x, +-y) of
    a P scaled by w, and Q at infinity."""
    F = G.F
    c = [F.from_ints(rng.integers(0, P_TOY, n).tolist(), "cpu")
         for _ in range(6)]
    x1, y1, z1, x2, y2, z2 = c
    w = F.from_ints(rng.integers(1, P_TOY, 64).tolist(), "cpu")
    z1[..., 0:64] = 0
    z2[..., 64:128] = 0
    for k in range(3):
        c[3 + k][..., 128:192] = c[k][..., 128:192]
    x2[..., 192:256], z2[..., 192:256] = x1[..., 192:256], z1[..., 192:256]
    y2[..., 192:256] = F.neg(y1[..., 192:256])
    s = slice(256, 320)
    x2[..., s] = F.mul(x1[..., s], F.sqr(w))
    y2[..., s] = F.mul(y1[..., s], F.mul(F.sqr(w), w))
    z2[..., s] = F.mul(z1[..., s], w)
    # the affine Q = (x2, y2); P = (x z^2, y z^3, z) against Q = (x, y) on
    # [256, 320) and Q = (x, -y) on [320, 384)
    ax, ay = x2.clone(), y2.clone()
    xm, ym, zm = x1.clone(), y1.clone(), z1.clone()
    e = slice(256, 384)
    ax[..., e], ay[..., e] = x1[..., e], y1[..., e]
    xm[..., e] = F.mul(x1[..., e], F.sqr(z1[..., e]))
    ym[..., e] = F.mul(y1[..., e], F.mul(F.sqr(z1[..., e]), z1[..., e]))
    ay[..., 320:384] = F.neg(ay[..., 320:384])
    q_inf = torch.zeros(n, dtype=torch.bool)
    q_inf[64:128] = True
    q_inf[1024:1100] = True
    return {"padd": (c, ()), "pmadd": ([xm, ym, zm, ax, ay], (q_inf,))}


@pytest.mark.parametrize("op", PAIR_OPS)
def test_g1_pair_schedule_matches_plain(toy, op):
    coords, masks = _toy_inputs(toy, 1200, np.random.default_rng(81))[op]
    for g, w in zip(group_op_split_plain(toy, op, coords, masks),
                    group_op_plain(toy, op, coords, masks)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("curve", CURVES12)
def test_g1_pair_schedule_matches_jax_golden_at_12_limbs(curve):
    g = json.loads(GOLDEN.read_text())[curve]
    G = device_curve(curve).g1
    P = [G.F.from_ints(c, "cpu") for c in g["P"]]
    Q = [G.F.from_ints(c, "cpu") for c in g["Q"]]
    A = [G.F.from_ints(c, "cpu") for c in g["A"][:2]]
    inf = torch.tensor(g["A"][2])
    args = {"padd": (P + Q, ()), "pmadd": (P + A, (inf,))}
    for op, (coords, masks) in args.items():
        got = group_op_split_plain(G, op, coords, masks)
        assert [G.F.to_ints(c) for c in got] == g["ops"][op], op


@pytest.mark.parametrize("curve", CURVES12)
def test_two_accumulator_product_matches_cios(curve):
    F = device_curve(curve).fq
    p, R = F.p, 1 << 384
    rng = random.Random(82)
    edges = [0, 1, p - 1, R % p]
    vals = edges + [rng.randrange(p) for _ in range(8)]
    Rinv = pow(R, -1, p)

    def words(v):
        return [(v >> (32 * j)) & 0xFFFFFFFF for j in range(12)]

    for x in vals:
        for y in vals:
            got = mul_eo_words(words(x), words(y), p, F.inv32)
            assert got == words(x * y * Rinv % p), (x, y)


def _halving_reads(G, b):
    """Every halving level of the buckets b: the words K3 reads for each
    half against the half copied; returns the levels checked."""
    nd, n32 = G.F.el_ndim, G.F.prime_field.n32
    levels = 0
    while b[0].shape[-1] > 1:
        half = b[0].shape[-1] // 2
        hv = [a[..., :half] for a in b] + [a[..., half:] for a in b]
        for v in hv:
            flat = v.contiguous().reshape(G.F.el_shape + (-1,))
            if input_layout(v, nd, n32) is None:
                assert half == 1            # read from a contiguous copy
                continue
            assert torch.equal(kernel_reads(v, nd, n32), flat)
        # the next level's buckets as K3 writes them: contiguous
        b = [a.contiguous() for a in group_op_plain(G, "padd", hv)]
        levels += 1
    return levels


def test_halves_read_in_place_match_copies(toy):
    """Fp: (1, W, B, L) toy buckets, L = 64 down to 1."""
    rng = np.random.default_rng(83)
    b = [torch.from_numpy(rng.integers(0, P_TOY, size=(3, 4, 64)))
         for _ in range(3)]
    b = [toy.F.from_ints(a.reshape(-1).tolist(), "cpu").reshape(
        toy.F.el_shape + (3, 4, 64)) for a in b]
    assert _halving_reads(toy, b) == 6


def test_halves_read_in_place_match_copies_on_fq2():
    """Fq2: (2, 8, W, B, L) buckets of alt_bn128 G2, L = 8 down to 1."""
    from libff_tpu_torch.workload import rand_elements

    G = device_curve("alt_bn128").g2
    rng = np.random.default_rng(84)
    b = [rand_elements(G.F, 2 * 3 * 8, rng, "cpu").reshape(2, 8, 2, 3, 8)
         for _ in range(3)]
    assert _halving_reads(G, b) == 3


def test_input_layout_reads_a_copy_of_what_it_cannot_address(toy):
    """Rows of any one stride are read in place (rows that follow each
    other are one row, a row broadcast has stride 0); a column broadcast
    and a transposed view have no (limb stride, row stride) form, and the
    wrapper reads a contiguous copy of them."""
    n32 = toy.F.n32
    a = toy.F.from_ints(list(range(12)), "cpu").reshape((n32, 3, 4))
    assert input_layout(a, 1, n32) == (12, 12, 12)
    assert input_layout(a[..., 1:3], 1, n32) == (12, 4, 2)
    rows = a[:, :1].expand(n32, 3, 4)
    assert input_layout(rows, 1, n32) == (12, 0, 4)
    assert torch.equal(kernel_reads(rows, 1, n32),
                       rows.contiguous().reshape(n32, -1))
    assert input_layout(a[..., :1].expand(n32, 3, 4), 1, n32) is None
    assert input_layout(a.transpose(1, 2), 1, n32) is None
