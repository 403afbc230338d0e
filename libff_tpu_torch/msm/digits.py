"""Scalar digit decomposition for the MSM, bit-exact with libff (port of
libff_tpu/msm/digits.py).

Scalars are plain-form (non-Montgomery) limb arrays ``(n32, *batch)``
int32 holding uint32 limbs; digits come out as int32.  The work is torch
integer ops in int64, as it was XLA ops in the JAX package.
"""

from __future__ import annotations

import torch

LIMB_BITS = 32


def num_signed_digits(modulus: int, num_bits: int, c: int) -> int:
    """field_get_num_signed_digits (field_utils.tcc:102-165): number of
    signed c-bit digits needed for any value < modulus, accounting for the
    overflow cascade of -1 (the worst case).  Copied from
    libff_tpu/msm/digits.py:35-51, whose module imports jax."""
    minus_one = modulus - 1
    naive = (num_bits + 1 + c - 1) // c
    sign_bit = 1 << (c - 1)
    max_signed = sign_bit - 1
    final_overflow = False
    for i in range(naive - 1, -1, -1):
        d = (minus_one >> (c * i)) & ((1 << c) - 1)
        if d & sign_bit:
            final_overflow = True
            break
        if d != max_signed:
            break
    return naive + 1 if final_overflow else naive


def _unsigned(limbs: torch.Tensor) -> torch.Tensor:
    if limbs.dtype != torch.int32:
        raise TypeError("scalar limbs are torch.int32")
    return limbs.to(torch.int64) & 0xFFFFFFFF


def _digit(u: torch.Tensor, c: int, idx: int) -> torch.Tensor:
    if not 1 <= c <= 16:
        raise ValueError(f"digit width {c} outside 1..16")
    n = u.shape[0]
    start = c * idx
    lo = start // LIMB_BITS
    sh = start - lo * LIMB_BITS
    v = (u[lo] >> sh) if lo < n else torch.zeros_like(u[0])
    if sh + c > LIMB_BITS and lo + 1 < n:
        v = v | (u[lo + 1] << (LIMB_BITS - sh))
    return v & ((1 << c) - 1)


def get_digit(limbs: torch.Tensor, c: int, idx: int) -> torch.Tensor:
    """Unsigned digit = bits [c*idx, c*(idx+1)) of the little-endian limb
    array (field_utils.tcc:50-100); bits beyond the top limb read as 0."""
    return _digit(_unsigned(limbs), c, idx).to(torch.int32)


def signed_digits(limbs: torch.Tensor, c: int, num_digits: int
                  ) -> torch.Tensor:
    """field_get_signed_digits (field_utils.tcc:205-239), vectorized:
    (num_digits, *batch) int32 digits in [-2^(c-1), 2^(c-1)] with
    sum_i digits[i] * 2^(c*i) == value."""
    u = _unsigned(limbs)
    carry = torch.zeros_like(u[0])
    overflow = torch.zeros_like(carry)
    out = []
    for idx in range(num_digits):
        carry = overflow | carry
        digit = _digit(u, c, idx) + carry
        overflow = (digit >> c) & 1
        carry = (digit >> (c - 1)) & 1
        signed = digit - carry * (1 << c)
        out.append(torch.where(overflow == 1, 0, signed))
    return torch.stack(out, dim=0).to(torch.int32)


def unsigned_digits(limbs: torch.Tensor, c: int, num_digits: int
                    ) -> torch.Tensor:
    """Plain c-bit windows: (num_digits, *batch) int32 in [0, 2^c)."""
    u = _unsigned(limbs)
    return torch.stack([_digit(u, c, i) for i in range(num_digits)],
                       dim=0).to(torch.int32)
