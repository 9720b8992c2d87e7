"""Hyperdimensional computing primitives (port of ``repro.core.hdc``).

Bipolar hypervectors live in {-1,+1}^D stored as int8; the packed form packs
32 dimensions per 32-bit word (dimension i -> word i//32, bit i%32, bit value
1 <=> +1). ``repro`` stores the words as uint32; the port stores the same bit
patterns as int32, because torch's shifts and bitwise ops are complete for
int32 only. ``>>`` on int32 is arithmetic, so every shift here is followed by
a mask. All similarity identities hold exactly in packed form:

    <a, b>        = D - 2 * hamming(pack(a), pack(b))
    rho           = 1 - 2|Delta|/D'     (Eq. 5)
"""
from __future__ import annotations

import torch

__all__ = [
    "random_hv", "bind", "bundle", "permute", "sign_project",
    "pack_bits", "unpack_bits", "popcount32", "hamming_packed", "dot_packed",
]

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_U32 = 0xFFFFFFFF


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits per 32-bit word (int32 bit patterns) -> int32 counts.

    torch has no popcount op, so this is the SWAR bit count, run in int64 on
    the zero-extended word so that no step can overflow a signed type."""
    x = words.to(torch.int64) & _U32
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return (((x * 0x01010101) & _U32) >> 24).to(torch.int32)


def random_hv(generator: torch.Generator, shape, dtype=torch.int8,
              device=None) -> torch.Tensor:
    """I.i.d. Rademacher hypervectors in {-1,+1}^shape[-1]."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator,
                         device=device)
    return torch.where(bits == 1, 1, -1).to(dtype)


def bind(*hvs: torch.Tensor) -> torch.Tensor:
    """Hadamard binding (elementwise product), associative and self-inverse."""
    out = hvs[0]
    for h in hvs[1:]:
        out = out * h
    return out


def bundle(hvs: torch.Tensor,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """Majority bundling over the leading axis with random tie-breaking."""
    s = torch.sum(hvs.to(torch.int32), dim=0, dtype=torch.int32)
    if generator is not None:
        tie = random_hv(generator, s.shape, dtype=torch.int32,
                        device=s.device)
        s = torch.where(s == 0, tie, s)
    return torch.where(s >= 0, 1, -1).to(torch.int8)


def permute(hv: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Cyclic permutation (role encoding)."""
    return torch.roll(hv, shift, dims=-1)


def sign_project(z: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """q = sign(R z): dense feature -> bipolar hypervector (paper Sec. 3.2).

    R is [D, d]; z is [..., d]. sign(0) is mapped to +1."""
    y = torch.matmul(z.to(torch.float32), R.to(torch.float32).T)
    return torch.where(y >= 0, 1, -1).to(torch.int8)


def _words_from_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bit pattern."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def pack_bits(bipolar: torch.Tensor) -> torch.Tensor:
    """Pack bipolar int8 [..., D] -> int32 words [..., D//32]. Bit=1 <=> +1."""
    D = bipolar.shape[-1]
    if D % 32:
        raise ValueError(f"D={D} must be a multiple of 32")
    bits = (bipolar > 0).to(torch.int64)
    bits = bits.reshape(*bipolar.shape[:-1], D // 32, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bipolar.device)
    return _words_from_u32(torch.sum(bits << shifts, dim=-1))


def unpack_bits(packed: torch.Tensor, D: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`."""
    if D != packed.shape[-1] * 32:
        raise ValueError("D mismatch")
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], D)
    return torch.where(bits == 1, 1, -1).to(torch.int8)


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Number of differing dimensions, from packed words (XOR + popcount)."""
    return torch.sum(popcount32(a ^ b), dim=-1, dtype=torch.int32)


def dot_packed(a: torch.Tensor, b: torch.Tensor, d_eff=None) -> torch.Tensor:
    """<a,b> over the first d_eff dims = d_eff - 2*hamming."""
    if d_eff is None:
        d_eff = a.shape[-1] * 32
    return d_eff - 2 * hamming_packed(a, b)
