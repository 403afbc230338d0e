"""K7e, the batched-affine bucket-add experiment, on the CPU through its
plain versions (libff_tpu_torch/affine_experiment.py):

- the madd and affine bodies against the JAX bodies of
  profile/affine_experiment.py:101-135, run eagerly over the JAX
  package's ``_KernelField`` on alt_bn128 (Ls = 1, T = 3), with lanes
  forced to x1 == x2 so that the doubling numerator runs;
- the lane inversion against a rendition of :149-187 (``jnp.roll`` for
  ``pltpu.roll``) on the toy field p = 65539 of
  tests/test_pallas_interpret.py (Ls = 4, T = 2), and on alt_bn128 against
  host integers: the 2-D prefix, the row suffix and o = suf (Ls = 4,
  T = 1); an eager alt_bn128 ladder would take ~14 s a step;
- the plain field ops against the JAX package's on 256-bit values that
  are not canonical, which the XOR-fed chains of madd and affine produce;
- the report's keys and its accept rule, from given times;
- the wrappers' operand checks, the inputs and the product count.

Inputs come from numpy seeds; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from libff_tpu.curves import formulas as jfml
from libff_tpu.curves.device import device_curve as jax_device_curve
from libff_tpu.fields.fp import PrimeField as JaxPrimeField
from libff_tpu.msm.pallas_insert import _KernelField
from libff_tpu_torch import affine_experiment as ae
from libff_tpu_torch.convert import limbs16_to_32, limbs32_to_16
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.fields.fp import (PrimeField, ints_to_limbs,
                                       limbs_to_ints, to16, to32)
from tests.test_pallas_interpret import P_TOY

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _inputs(p: int, n32: int, I: int, T: int, L: int, seed: int):
    """(I, T, n32, L) int32 limbs of random residues in [1, p)."""
    rng = np.random.default_rng(seed)
    vals = [1 + int.from_bytes(rng.bytes(40), "little") % (p - 1)
            for _ in range(I * T * L)]
    limbs = ints_to_limbs(vals, n32).reshape(n32, I, T, L)
    return torch.from_numpy(limbs.transpose(1, 2, 0, 3).copy().view(np.int32))


def _jax_step(x: torch.Tensor, t: int) -> jnp.ndarray:
    """Step t of an (I, T, n32, L) tensor as the JAX package's (n16, I * L)
    16-bit limbs."""
    u = x[:, t].permute(1, 0, 2).reshape(x.shape[2], -1).numpy()
    return jnp.asarray(limbs32_to_16(u.view(np.uint32)))


def _from_jax(o, I: int, L: int) -> torch.Tensor:
    """(n16, I * L) JAX limbs -> the port's (I, n32, L) int32."""
    u = limbs16_to_32(np.asarray(o)).reshape(-1, I, L).transpose(1, 0, 2)
    return torch.from_numpy(np.ascontiguousarray(u).view(np.int32))


@pytest.fixture(scope="module")
def curves():
    return jax_device_curve("alt_bn128"), device_curve("alt_bn128")


@pytest.fixture(scope="module")
def madd_case(curves):
    """Inputs (I = 2, T = 3, Ls = 1) with x1 == x2 forced at step 1 in
    lanes 0-7 of instance 0 and at step 2 in lanes 8-11 of instance 1."""
    _, dc = curves
    F = dc.fq
    a, b = (_inputs(F.p, 8, 2, 3, 128, s) for s in (1, 2))
    o1 = ae.affine_body_plain(F, a[:, :1], b[:, :1])
    a[0, 1, :, :8] = o1[0, :, :8]
    o2 = ae.affine_body_plain(F, a[:, :2], b[:, :2])
    a[1, 2, :, 8:12] = o2[1, :, 8:12]
    return a, b


def test_madd_plain_matches_jax_body(curves, madd_case):
    jdc, dc = curves
    a, b = madd_case
    I, T, _, L = a.shape
    JF = _KernelField(jdc.fq)
    o = jnp.zeros((16, I * L), jnp.uint32)
    for t in range(T):
        x, y = _jax_step(a, t), _jax_step(b, t)
        X3, Y3, Z3 = jfml.rcb_madd_a0(JF, o, x, y, x, y, jdc.g1._b3_host)
        o = X3 ^ Y3 ^ Z3
    assert torch.equal(ae.madd_body_plain(dc.g1, a, b), _from_jax(o, I, L))


def test_affine_plain_matches_jax_body(curves, madd_case):
    jdc, dc = curves
    a, b = madd_case
    I, T, _, L = a.shape
    JF = _KernelField(jdc.fq)
    o = jnp.zeros((16, I * L), jnp.uint32)
    doublings = 0
    for t in range(T):
        x1, y1 = o, _jax_step(a, t)
        x2, y2 = _jax_step(a, t), _jax_step(b, t)
        dinv = _jax_step(b, t)
        x_eq = jnp.all(x1 == x2, axis=0, keepdims=True)
        doublings += int(x_eq.sum())
        num_add = JF.sub(y2, y1)
        sq = JF.mul(x1, x1)
        num_dbl = JF.add(JF.add(sq, sq), sq)
        num = jnp.where(x_eq, num_dbl, num_add)
        lam = JF.mul(num, dinv)
        x3 = JF.sub(JF.sub(JF.mul(lam, lam), x1), x2)
        y3 = JF.sub(JF.mul(lam, JF.sub(x1, x3)), y1)
        o = x3 ^ y3
    assert doublings == 12
    assert torch.equal(ae.affine_body_plain(dc.fq, a, b), _from_jax(o, I, L))


def _jax_inv_step(JF, p: int, d):
    """affine_experiment.py:157-187 on one (n16, Ls, 128) tile d, with
    jnp.roll for pltpu.roll."""
    Ls = d.shape[1]
    pre = d
    stride = 1
    while stride < 128:
        rolled = jnp.roll(pre, stride, 2)
        lane = lax.broadcasted_iota(jnp.int32, pre.shape, 2)
        pre = jnp.where(lane >= stride, JF.mul(pre, rolled), pre)
        stride *= 2
    s = 1
    while s < Ls:
        shifted = jnp.roll(pre, s, 1)
        sub = lax.broadcasted_iota(jnp.int32, pre.shape, 1)
        pre = jnp.where(sub >= s, JF.mul(pre, shifted), pre)
        s *= 2
    suf = d
    stride = 1
    while stride < 128:
        rolled = jnp.roll(suf, 128 - stride, 2)
        lane = lax.broadcasted_iota(jnp.int32, suf.shape, 2)
        suf = jnp.where(lane < 128 - stride, JF.mul(suf, rolled), suf)
        stride *= 2
    acc = pre
    for bit in bin(p - 2)[2:][1:]:
        acc = JF.mul(acc, acc)
        if bit == "1":
            acc = JF.mul(acc, pre)
    return JF.mul(JF.mul(pre, suf), acc)


def test_lane_inv_plain_matches_jax_rendition_on_toy_field():
    JF = _KernelField(JaxPrimeField(P_TOY, name="toy_Fp"))
    F = PrimeField(P_TOY)
    I, T, Ls = 1, 2, 4
    a = _inputs(P_TOY, F.n32, I, T, Ls * 128, 3)
    o, chk = ae.lane_inv_plain(F, a)
    for i in range(I):
        want = []
        for t in range(T):
            d = limbs32_to_16(a[i, t].numpy().view(np.uint32))
            w = _jax_inv_step(JF, P_TOY, jnp.asarray(d.reshape(-1, Ls, 128)))
            want.append(limbs16_to_32(np.asarray(w).reshape(-1, Ls * 128)))
        assert np.array_equal(o[i].numpy().view(np.uint32), want[-1])
        assert np.array_equal(chk[i].numpy().view(np.uint32),
                              want[0] ^ want[1])


def test_lane_inv_plain_matches_host_on_alt_bn128(curves):
    _, dc = curves
    F = dc.fq
    p, R = F.p, F.mp.R
    Ls, L = 4, 512
    a = _inputs(p, 8, 1, 1, L, 4)
    d = limbs_to_ints(a[0, 0].numpy().view(np.uint32))
    rinv = pow(R, -1, p)

    def mont(x, y):
        return x * y * rinv % p

    row = [[d[r * 128 + j] for j in range(128)] for r in range(Ls)]
    pre, suf = [], []
    for r in range(Ls):
        acc = None
        for j in range(128):
            up = row[r][j] if acc is None else mont(acc, row[r][j])
            acc = up
            pre.append(up if r == 0 else mont(up, pre[(r - 1) * 128 + j]))
        back, acc = [], None
        for j in reversed(range(128)):
            acc = row[r][j] if acc is None else mont(acc, row[r][j])
            back.append(acc)
        suf += back[::-1]
    x = to16(a[0, 0].reshape(8, Ls, 128))
    got_pre, got_suf = (limbs_to_ints(to32(v).reshape(8, L).numpy()
                                      .view(np.uint32))
                        for v in ae.lane_scans(F.plain, x))
    assert got_pre == pre and got_suf == suf
    o, chk = ae.lane_inv_plain(F, a)
    assert limbs_to_ints(o[0].numpy().view(np.uint32)) == suf
    assert torch.equal(o, chk)


def test_plain_field_ops_match_jax_on_non_canonical_values(curves):
    jdc, dc = curves
    JF, P, p = jdc.fq, dc.fq.plain, dc.fq.p
    rng = np.random.default_rng(5)
    top = (1 << 256) - 1
    vals = [top, top - 1, p, p + 1, (1 << 256) - p, 0, 1, 2 * p,
            (1 << 255) + p] + [int.from_bytes(rng.bytes(32), "little")
                               for _ in range(55)]
    x32 = ints_to_limbs(vals, 8)
    y32 = ints_to_limbs(vals[::-1], 8)
    jx, jy = (jnp.asarray(limbs32_to_16(v)) for v in (x32, y32))
    tx, ty = (to16(torch.from_numpy(v.view(np.int32))) for v in (x32, y32))
    KF = _KernelField(JF)
    cases = {"add": (P.add(tx, ty), JF.add(jx, jy)),
             "sub": (P.sub(tx, ty), JF.sub(jx, jy)),
             "mul": (P.mul(tx, ty), JF.mul_unrolled(jx, jy)),
             "b3": (P.mul_small_const(tx, 9), KF.mul_small_const(jx, 9))}
    for name, (got, want) in cases.items():
        got32 = to32(got).numpy().view(np.uint32)
        assert np.array_equal(got32, limbs16_to_32(np.asarray(want))), name
    # the cases reach the carry out of 2^256 that fp.cuh's add must keep
    assert any(x + y >= (1 << 256) + p for x, y in zip(vals, vals[::-1]))


def test_report_keys_and_accept_rule():
    p = device_curve("alt_bn128").q
    rates = {"lo": 64 * 1980e6 * 132, "hi": 32 * 1980e6 * 132}
    T, Ls = 2048, 4
    inst = {"madd": 10, "affine": 20, "lane_inv": 10}
    n = {k: v * T * Ls * 128 for k, v in inst.items()}
    # ns per element: madd 1.0, affine 0.3, lane_inv 0.85 -> total 1.15
    ms = {"madd": 1.0 * n["madd"] * 1e-6, "affine": 0.3 * n["affine"] * 1e-6,
          "lane_inv": 0.85 * n["lane_inv"] * 1e-6}
    half = {k: v / 2 for k, v in ms.items()}
    rep = ae.report(ms, half, T, Ls, inst, rates, p)
    for key in ("metric", "platform", "T", "lanes", "madd_ns_per_el",
                "affine_body_ns_per_el", "lane_inv_ns_per_el",
                "affine_total_ns_per_el", "traffic_credit", "accept",
                "note", "instances"):
        assert key in rep, key
    assert rep["platform"] == "gpu" and rep["lanes"] == 512
    assert rep["traffic_credit"] == 0.2
    assert rep["affine_total_ns_per_el"] == pytest.approx(1.15)
    # 1.15 < 1.0 * (1 + 0.2): accepted, though not under (1 - 0.2)
    assert rep["accept"] is True
    assert rep["affine_body_ns_per_el"] == pytest.approx(0.3)
    ms["lane_inv"] = 0.95 * n["lane_inv"] * 1e-6
    assert ae.report(ms, half, T, Ls, inst, rates, p)["accept"] is False
    assert "(1 - traffic_credit)" in rep["note"]
    assert rep["madd_t_over_half_t"] == pytest.approx(2.0)
    # a product is 136 lo and 128 hi: 23.4 ps; madd 11, lane_inv 310.73
    assert rep["madd_bound_ns_per_el"] == pytest.approx(0.2578, rel=1e-3)
    assert rep["lane_inv_bound_ns_per_el"] == pytest.approx(7.283, rel=1e-3)
    assert rep["madd_share_of_bound"] == pytest.approx(0.2578, rel=1e-3)


def test_lane_inv_products():
    p = device_curve("alt_bn128").q
    # prefix 4 * 127 + 3 * 128, suffix 4 * 127, over 512 lanes; the
    # inverse's 306 products (a 5-bit sliding window: 16 for its table,
    # 252 squarings, 38 windows; the ladder makes 253 + 109); the two of o
    assert ae.lane_inv_products(4, p) == (892 + 508) / 512 + 306 + 2
    assert ae.lane_inv_products(4, p) == 310.734375
    assert ae.lane_inv_products(1, p) == 2 * 127 / 128 + 308


def test_random_inputs_are_canonical_and_nonzero(curves):
    _, dc = curves
    F = dc.fq
    a, b = ae.random_inputs(F, 2, 3, 128, 1, CPU)
    for x in (a, b):
        assert x.shape == (2, 3, 8, 128) and x.dtype == torch.int32
        vals = limbs_to_ints(x.permute(2, 0, 1, 3).reshape(8, -1).numpy()
                             .view(np.uint32))
        assert all(0 < v < F.p for v in vals)
    assert not torch.equal(a, b)


def test_wrappers_check_operands(curves):
    _, dc = curves
    F, G = dc.fq, dc.g1
    a, b = (_inputs(F.p, 8, 1, 2, 128, s) for s in (6, 7))
    with pytest.raises(TypeError):
        ae.affine_body(F, a.to(torch.int64), b.to(torch.int64))
    with pytest.raises(ValueError):                  # limbs
        ae.madd_body(G, a[:, :, :4], b[:, :, :4])
    with pytest.raises(ValueError):                  # lanes
        ae.lane_inv(F, a[..., :100])
    with pytest.raises(ValueError):                  # shapes differ
        ae.madd_body(G, a, b[:, :1])
    with pytest.raises(ValueError):                  # steps not contiguous
        ae.affine_body(F, *(x.transpose(2, 3).contiguous().transpose(2, 3)
                            for x in (a, b)))
    with pytest.raises(ValueError):                  # no kernel there
        ae.lane_inv(F, a.to("meta"))
    # a view of the first steps is taken as it is
    assert torch.equal(ae.madd_body(G, a[:, :1], b[:, :1]),
                       ae.madd_body_plain(G, a[:, :1].contiguous(),
                                          b[:, :1].contiguous()))
