"""The Fermat inverses of the prime field and of Fq2 on the CPU: the plain
versions of kernels K1e inv and K4e inv (``csrc/fp_ops.cu``), and what
their wrappers hand the kernels.

On the card ``PrimeField.inv`` and ``ExtField.inv`` launch one kernel
that runs fp.cuh's ``pow_ladder`` over the words of p - 2 in each
thread; on a CPU tensor they run ``pow_static``'s ladder of plain
products, and ``fp_inv_plain`` / ``fq2_inv_plain`` run the same ladder on
the plain field on any device.  Checked here:

- the exponent words and leading bit the wrappers pass, and the
  arguments of the launch;
- the kernel's ladder, mirrored word by word in host integers, and the
  plain ladder, on every element of the toy field of
  tests/test_pallas_interpret.py (p = 65539) against pow(a, p - 2, p),
  0 against 0;
- the port's Fp and Fq2 inverses against a golden written once from the
  JAX package's ``PrimeField.inv`` (libff_tpu/fields/fp.py:465-468) and
  Fq2 ``inv`` (libff_tpu/fields/tower.py:301-307) at a dozen alt_bn128
  elements (tests/data/inverse_golden.json; ``PYTHONPATH=. python
  tests/test_torch_inverse.py`` from the repository root writes it
  again);
- the dispatch: a CPU tensor runs the plain version and launches
  nothing; what the kernels do not take raises.

All comparisons are exact.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from libff_tpu_torch import _build
from libff_tpu_torch.curves.device import device_curve
from libff_tpu_torch.fields import fp as tfp
from libff_tpu_torch.fields import tower as ttw
from libff_tpu_torch.workload import rand_elements
from tests.test_pallas_interpret import P_TOY

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "data" / "inverse_golden.json"


@pytest.fixture(scope="module")
def dc():
    return device_curve("alt_bn128")


def ladder_mirror(x: int, words, top: int, p: int) -> int:
    """fp.cuh's pow_ladder on host integers, bit by bit as the kernel reads
    its exponent words (values, not Montgomery forms: the ladder's
    products are the field's)."""
    acc = x
    for i in range(top - 1, -1, -1):
        acc = acc * acc % p
        if (words[i >> 5] >> (i & 31)) & 1:
            acc = acc * x % p
    return acc


@pytest.mark.parametrize("field", ["fq", "fr"])
def test_exponent_words_are_p_minus_2(dc, field):
    F = getattr(dc, field)
    words = list(F.inv_exp_c)
    assert len(words) == F.n32 == 8
    assert sum(w << (32 * i) for i, w in enumerate(words)) == F.p - 2
    assert F.inv_exp_top == (F.p - 2).bit_length() - 1
    assert (words[F.inv_exp_top >> 5] >> (F.inv_exp_top & 31)) & 1
    if field == "fq":
        # K7e's built-in constant (csrc/affine_experiment.cu): the same
        # exponent, so both kernels run one ladder
        assert words == [0xd87cfd45, 0x3c208c16, 0x6871ca8d, 0x97816a91,
                         0x8181585d, 0xb85045b6, 0xe131a029, 0x30644e72]
        assert tfp.ladder_products(F.p - 2) == 362


@pytest.mark.parametrize("field,shape", [("fq", (3,)), ("fq", ()),
                                         ("fq2", (2, 3)), ("fq2", ())])
def test_launch_arguments(dc, monkeypatch, field, shape):
    """The wrapper's launch: one call of the entry point with the element
    count, the field and p - 2's words and leading bit, counted under
    the kernel's own name."""
    F = getattr(dc, field)
    B = F.prime_field
    calls = []
    monkeypatch.setattr(_build, "function",
                        lambda stem, name, args: (stem, name, len(args)))
    monkeypatch.setattr(_build, "launch",
                        lambda fn, what, dev, *args: calls.append(
                            (fn, what, args)))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    a = torch.zeros(F.el_shape + shape, dtype=torch.int32)
    name = "K1e inv" if field == "fq" else "K4e inv"
    entry = "fp_inv" if field == "fq" else "fq2_inv"
    before = _build.LAUNCHES[name]
    out = tfp.launch_inv(B, entry, name, a)
    assert out.shape == a.shape
    assert _build.LAUNCHES[name] == before + 1
    (fn, what, args), = calls
    assert fn == ("fp_ops", entry, 10) and what == name
    n = 1
    for s in shape:
        n *= s
    assert args[2:6] == (n, 8, B.p_c, B.inv32)
    assert list(args[6]) == list(B.inv_exp_c) and args[7] == B.inv_exp_top


def test_ladder_on_every_toy_element():
    """The kernel's ladder (mirrored) and the plain ladder, K1e inv's
    plain version, on all of the toy field: a^(p-2), 0 to 0."""
    F = tfp.PrimeField(P_TOY, name="toy_Fp")
    p = F.p
    words, top = list(F.inv_exp_c), F.inv_exp_top
    want = [pow(v, p - 2, p) for v in range(p)]
    assert [ladder_mirror(v, words, top, p) for v in range(p)] == want
    a = F.from_ints(list(range(p)), "cpu")
    assert F.to_ints(tfp.fp_inv_plain(F, a)) == want
    assert torch.equal(F.inv(a[:, :4096]), tfp.fp_inv_plain(F, a[:, :4096]))


def test_ladder_mirror_on_alt_bn128(dc):
    """The mirrored kernel ladder over the eight words of alt_bn128's
    p - 2 is the Fermat inverse."""
    F = dc.fq
    vals = [0, 1, 2, F.p - 1, F.mp.R % F.p, 3 ** 100 % F.p]
    assert [ladder_mirror(v, list(F.inv_exp_c), F.inv_exp_top, F.p)
            for v in vals] == [pow(v, F.p - 2, F.p) for v in vals]


def sliding_window_pow(x: int, e: int, w: int, p: int):
    """x^e mod p by a left-to-right sliding window of w bits, with the
    products it makes counted: a^2 and the odd powers below 2^w first."""
    count = 0

    def mul(u, v):
        nonlocal count
        count += 1
        return u * v % p

    table = {1: x}
    if w > 1:
        x2 = mul(x, x)
        for k in range(3, 1 << w, 2):
            table[k] = mul(table[k - 2], x2)
    bits, i, acc = bin(e)[2:], 0, None
    while i < len(bits):
        if bits[i] == "0":
            acc, i = mul(acc, acc), i + 1
            continue
        j = min(i + w, len(bits)) - 1
        while bits[j] == "0":
            j -= 1
        if acc is None:
            acc = table[int(bits[i:j + 1], 2)]
        else:
            for _ in range(j - i + 1):
                acc = mul(acc, acc)
            acc = mul(acc, table[int(bits[i:j + 1], 2)])
        i = j + 1
    return acc, count


@pytest.mark.parametrize("field", ["toy", "fq", "fr"])
def test_window_products_count_a_chain(dc, field):
    """window_products, the products the inverses' bounds count, is the
    length of a sliding-window chain that computes a^(p-2), at each width
    and at its best; width 1 is the kernel's ladder (362 for alt_bn128's
    Fq, where the best window needs fewer)."""
    p = P_TOY if field == "toy" else getattr(dc, field).p
    e, x = p - 2, 3 ** 40 % p
    counts = {}
    for w in range(1, 9):
        got, counts[w] = sliding_window_pow(x, e, w, p)
        assert got == pow(x, e, p)
        assert tfp.window_products(e, [w]) == counts[w]
    assert counts[1] == tfp.ladder_products(e)
    assert tfp.window_products(e) == min(counts.values())
    if field == "fq":
        assert tfp.window_products(e) < 362 == counts[1]


@pytest.mark.parametrize("impl", ["inv", "plain"])
@pytest.mark.parametrize("field", ["fq", "fq2"])
def test_inverse_matches_jax_golden(dc, field, impl):
    gold = json.loads(GOLDEN.read_text())[field]
    F = getattr(dc, field)
    if field == "fq":
        a = F.from_ints(gold["a"], "cpu")
        out = F.inv(a) if impl == "inv" else tfp.fp_inv_plain(F, a)
        assert F.to_ints(out) == gold["inv"]
    else:
        a = F.from_host_batch([tuple(v) for v in gold["a"]], "cpu")
        out = F.inv(a) if impl == "inv" else ttw.fq2_inv_plain(F, a)
        assert [list(v) for v in F.to_host_batch(out)] == gold["inv"]


@pytest.mark.parametrize("field", ["fq", "fq2"])
def test_cpu_runs_the_plain_version(dc, field):
    """A CPU tensor, batched or one element as to_affine gives it, runs
    the plain version and launches nothing."""
    F = getattr(dc, field)
    plain = tfp.fp_inv_plain if field == "fq" else ttw.fq2_inv_plain
    a = rand_elements(F, 3, np.random.default_rng(3), "cpu")
    launches = dict(_build.LAUNCHES)
    for x in (a, a[..., 0]):
        assert torch.equal(F.inv(x), plain(F, x))
    assert dict(_build.LAUNCHES) == launches


@pytest.mark.parametrize("case", ["device", "dtype", "shape"])
@pytest.mark.parametrize("field", ["fq", "fq2"])
def test_wrappers_reject(dc, field, case):
    """What the kernels do not take raises: a tensor on a device with no
    kernel (never computed on the CPU), another dtype, another element
    shape."""
    F = getattr(dc, field)
    a = F.one((2,), "cpu").contiguous()
    if case == "device":
        a = a.to("meta")
    elif case == "dtype":
        a = a.to(torch.int64)
    else:
        a = a[..., :4, :]
    with pytest.raises((ValueError, TypeError)):
        F.inv(a)


def _golden_values(p: int) -> list[int]:
    """A dozen alt_bn128 Fq values: the edges and a few others."""
    R = 1 << 256
    return [0, 1, 2, p - 1, p - 2, R % p, p - R % p, (p - 1) // 2,
            (1 << 128) % p, 3 ** 160 % p, 5 ** 111 % p, 7 ** 90 % p]


def _write_golden() -> None:
    """The golden of test_inverse_matches_jax_golden, from the JAX
    package's PrimeField.inv and Fq2 inv (eager, on the CPU)."""
    from libff_tpu.curves.device import device_curve as jax_device_curve

    jdc = jax_device_curve("alt_bn128")
    p = jdc.fq.p
    vals = _golden_values(p)
    pairs = [(0, 0), (1, 0), (0, 1)] + list(zip(vals[3:], vals[:0:-1]))
    out = {"fq": {"a": vals,
                  "inv": jdc.fq.to_ints(jdc.fq.inv(jdc.fq.from_ints(vals)))},
           "fq2": {"a": [list(v) for v in pairs],
                   "inv": [list(v) for v in jdc.fq2.to_host_batch(
                       jdc.fq2.inv(jdc.fq2.from_host_batch(pairs)))]}}
    for v, w in zip(vals, out["fq"]["inv"]):
        assert v * w % p == (1 if v else 0)
    GOLDEN.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    _write_golden()
