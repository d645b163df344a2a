"""Order-preserving key encoding ("row format"), the sort subset.

The port of the JAX package's `ops/keycode.py`: every key column is
encoded into fixed-width unsigned words whose integer order is the
logical order, so a multi-key sort is a lexicographic sort of words:

  * signed ints:  flip the sign bit
  * floats:       sign bit set -> ~bits, else bits | signbit (NaN with the
                  sign bit clear sorts last, -0.0 before 0.0)
  * bools:        0/1
  * strings:      dictionary codes are already order-preserving (sorted
                  dictionaries, see `strings.py`)
  * descending:   bitwise NOT of the word
  * nulls:        a separate leading null word (0/1/2) per nullable key

Representation in torch (which has no unsigned compare on the CPU):
* a 32-bit word is a non-negative int64 in [0, 2^32);
* a 64-bit code (`encode_orderable` of an 8-byte type) is the int64 with
  the u64's bit pattern; `encode_key_words` splits it into two words.

Storage differs from the JAX package (`batch.py`): UInt16 lives in
int32, UInt32 in int64 and UInt64 in int64 with wrap, so these functions
take the column's logical dtype beside its data. A UInt64's bit pattern
is its code as it is (the wrap is undone by reading the bits as
unsigned); a UInt32 is one word, not two. Float64 is f64 on every
device: the port takes the JAX package's CPU branch (the full 64-bit
encoding), never its TPU branch, which orders f64 by f32.

The bit-budget packing (`column_bit_width`, `pack_keys_single_word`)
packs several key columns into one u64 word, held as the int64 with its
bits: every `>>` of a packed word is masked after it (torch's shift of
an int64 is arithmetic), and packed words are ordered as unsigned
(`orderable` flips their top bit, or `sort_ops` is told UInt64).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..dtypes import DataType

__all__ = ["encode_orderable", "encode_key_words", "decode_orderable",
           "col_to_u32_words", "col_from_u32_words", "lex_sort_indices",
           "U32", "code_bits", "orderable_i64", "column_bit_width",
           "pack_keys_single_word", "unpack_keys_single_word",
           "u64_to_signed"]

U32 = 0xFFFFFFFF
_SIGN64 = -(1 << 63)        # the int64 whose bits are 1 << 63


def code_bits(dtype: DataType) -> int:
    """Width in bits of the orderable code of a logical dtype: 64 for
    8-byte types, else 32."""
    name = repr(dtype)
    if name in ("Int64", "UInt64", "Float64", "Time") or \
            name.startswith(("Datetime", "Duration")):
        return 64
    return 32


def _flip_mask(dtype: DataType) -> int:
    """The bits that `descending` inverts in a 32-bit code: the integer
    type's own width below 32 bits (the JAX package NOTs the code in its
    own dtype before widening it), else all 32."""
    w = dtype.bit_width() if dtype.is_integer else 32
    return (1 << min(w, 32)) - 1


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an integer tensor as a non-negative int64."""
    return x.to(torch.int64) & U32


def encode_orderable(x: torch.Tensor, dtype: DataType,
                     descending: bool = False) -> torch.Tensor:
    """Map a column's storage tensor to unsigned codes with order
    preserved: int64 in [0, 2^32) for a 32-bit code, the u64's bits for
    a 64-bit one (`code_bits`)."""
    name = repr(dtype)
    if code_bits(dtype) == 64:
        if name == "Float64":
            b = x.contiguous().view(torch.int64)
            u = torch.where(b < 0, ~b, b | _SIGN64)
        elif name == "UInt64":
            u = x.to(torch.int64)
        else:  # Int64 and the 64-bit temporal types: flip the sign bit
            u = x.to(torch.int64) ^ _SIGN64
        return ~u if descending else u
    if name == "Boolean":
        u = x.to(torch.int64)
    elif name == "Float32":
        b = _u32(x.contiguous().view(torch.int32))
        u = torch.where(b >= (1 << 31), b ^ U32, b | (1 << 31))
    elif name.startswith("UInt"):
        u = x.to(torch.int64)
    else:
        # signed ints of 1, 2 or 4 bytes (strings and dates are int32
        # codes): flip the sign bit of the type's own width, then widen as
        # the JAX package widens the unsigned result
        w = x.element_size() * 8
        u = (x.to(torch.int64) + (1 << (w - 1))) & ((1 << w) - 1)
    return u ^ _flip_mask(dtype) if descending else u


def orderable_i64(x: torch.Tensor, dtype: DataType) -> torch.Tensor:
    """A column's orderable code as a signed int64 with the same order
    (`torch.searchsorted` and `torch.sort` compare int64 as signed): a
    64-bit code with its top bit flipped, a 32-bit one as it is."""
    u = encode_orderable(x, dtype)
    return u ^ _SIGN64 if code_bits(dtype) == 64 else u


def encode_key_words(x: torch.Tensor, dtype: DataType,
                     validity: Optional[torch.Tensor], descending: bool,
                     nulls_last: bool) -> List[torch.Tensor]:
    """Encode one key column (+null placement) into a list of 32-bit
    words, most significant first. Nulls get an extra leading word
    (0 first / 1 valid / 2 last) only when validity exists, and the
    value words of null rows are zeroed so nulls tie (and stay stable)."""
    u = encode_orderable(x, dtype, descending)
    words: List[torch.Tensor] = []
    if validity is not None:
        null_word = 2 if nulls_last else 0
        words.append(torch.where(validity, 1, null_word).to(torch.int64))
    if code_bits(dtype) == 64:
        words += [(u >> 32) & U32, u & U32]
    else:
        words.append(u)
    if validity is not None:
        words[1:] = [torch.where(validity, w, 0) for w in words[1:]]
    return words


def decode_orderable(u: torch.Tensor, dtype: DataType,
                     descending: bool) -> torch.Tensor:
    """Inverse of `encode_orderable`: codes back to the dtype's storage
    tensor."""
    from ..batch import storage_torch_dtype
    stor = storage_torch_dtype(dtype)
    name = repr(dtype)
    if code_bits(dtype) == 64:
        if descending:
            u = ~u
        if name == "Float64":
            raw = torch.where(u < 0, u ^ _SIGN64, ~u)
            return raw.view(torch.float64)
        if name == "UInt64":
            return u
        return u ^ _SIGN64
    if descending:
        u = u ^ _flip_mask(dtype)
    if name == "Boolean":
        return (u & 1) != 0
    if name == "Float32":
        raw = torch.where(u >= (1 << 31), u ^ (1 << 31), u ^ U32)
        return _from_u32(raw, torch.int32).view(torch.float32)
    if name.startswith("UInt"):
        return u.to(stor)
    w = stor.itemsize * 8
    return (u - (1 << (w - 1))).to(stor)


def _from_u32(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A u32 word (int64 in [0, 2^32)) as the 4-byte dtype with its bits."""
    return (w - ((w >> 31) << 32)).to(torch.int32).view(dtype)


def col_to_u32_words(data: torch.Tensor, dtype: DataType
                     ) -> List[torch.Tensor]:
    """A column's storage bits as 1 or 2 32-bit words (high word first),
    for payloads that ride through a sort. Types narrower than 4 bytes
    widen as the JAX package widens them (signed or unsigned); UInt32,
    stored in int64, is one word."""
    name = repr(dtype)
    if data.dtype == torch.bool:
        return [data.to(torch.int64)]
    if code_bits(dtype) == 64:
        b = data.contiguous().view(torch.int64)
        return [(b >> 32) & U32, b & U32]
    if data.dtype in (torch.float32, torch.int32):
        return [_u32(data.contiguous().view(torch.int32))]
    if name == "UInt32" or data.dtype == torch.uint8:
        return [data.to(torch.int64)]
    return [_u32(data)]


def col_from_u32_words(words: Sequence[torch.Tensor], dtype: DataType
                       ) -> torch.Tensor:
    """Inverse of `col_to_u32_words`: the words back to the dtype's
    storage tensor."""
    from ..batch import storage_torch_dtype
    stor = storage_torch_dtype(dtype)
    if len(words) == 2:
        b = (words[0] << 32) | words[1]
        return b.view(stor) if stor.is_floating_point else b
    w = words[0]
    if stor == torch.bool:
        return w != 0
    if stor in (torch.float32, torch.int32):
        return _from_u32(w, stor)
    if stor in (torch.int8, torch.int16):
        return _from_u32(w, torch.int32).to(stor)
    return w.to(stor)


def lex_sort_indices(key_words: Sequence[torch.Tensor],
                     tail_operands: Sequence[torch.Tensor] = ()
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                torch.Tensor]:
    """Stable lexicographic sort by the given 32-bit key words, with
    32-bit tail words riding along. Returns (sorted key words, sorted
    tail words, permutation); the permutation maps sorted slot ->
    original row. It is the sort's injected row index: no index word
    rides as a payload."""
    from .merge_sort import merge_sort_words
    nk = len(key_words)
    out = merge_sort_words(list(key_words) + list(tail_operands), nk,
                           stable=True)
    return list(out[:nk]), list(out[nk + 1:]), out[nk]


# ---------------------------------------------------------------------------
# bit-budget packing: several key columns in one u64 word (the distributed
# engine's group, join, distinct and sort keys)
# ---------------------------------------------------------------------------

_U64 = (1 << 64) - 1


def u64_to_signed(x: int) -> int:
    """A u64 value (a Python int in [0, 2^64)) as the int64 with its
    bits."""
    x &= _U64
    return x - (1 << 64) if x >> 63 else x


def column_bit_width(x: torch.Tensor, dtype: DataType,
                     validity: Optional[torch.Tensor]) -> Tuple[int, int]:
    """(bits, min) of a column's orderable codes over its valid rows, in
    one readback: `min` is the smallest code (a u64 as a Python int;
    2^64 - 1 where no row is valid) and `bits` the width of (code - min)
    plus one reserved slot for null, at least 1.

    The JAX package takes ceil(log2(span + 2)) in f64, which rounds a
    span within half an f64 ulp below 2^k - 1 (k >= 53) down to k - 1
    bits, too few for the code span + 1; here the width is
    (span + 1).bit_length() on the host, exact for every span."""
    u = encode_orderable(x, dtype) ^ _SIGN64 if code_bits(dtype) == 64 \
        else encode_orderable(x, dtype)
    # 64-bit codes ordered as signed int64 with the top bit flipped
    if validity is not None:
        hi = torch.iinfo(torch.int64).max if code_bits(dtype) == 64 \
            else U32
        lo = torch.iinfo(torch.int64).min if code_bits(dtype) == 64 else 0
        mn = torch.where(validity, u, torch.full_like(u, hi)).min()
        mx = torch.where(validity, u, torch.full_like(u, lo)).max()
    else:
        mn, mx = u.min(), u.max()
    mn, mx = torch.stack([mn, mx]).tolist()
    if code_bits(dtype) == 64:
        mn, mx = (mn ^ _SIGN64) & _U64, (mx ^ _SIGN64) & _U64
    elif validity is not None and mn == U32 and mx == 0:
        mn = _U64                   # no valid row: the u64 fill
    span = mx - min(mn, mx)
    return max((span + 1).bit_length(), 1), mn


def pack_keys_single_word(columns: Sequence[torch.Tensor],
                          dtypes: Sequence[DataType],
                          validities: Sequence[Optional[torch.Tensor]],
                          bits: Sequence[int], mins: Sequence[int],
                          nulls_last: Optional[Sequence[bool]] = None
                          ) -> torch.Tensor:
    """Pack key columns into ONE u64 word (an int64 tensor with its bits)
    given host-known bit budgets and minimum codes: order-preserving
    within each column and lexicographic across them, the first column
    most significant.

    Null placement per column: nulls first encode null as 0 and a value
    as code - min + 1; nulls last encode a value as code - min and null
    as 2^b - 1 (the budget leaves room for it)."""
    total = sum(bits)
    if total > 64:
        raise ValueError(f"bit budget {total} exceeds 64")
    if nulls_last is None:
        nulls_last = [False] * len(bits)
    acc = None
    for x, dt, valid, b, mn, nl in zip(columns, dtypes, validities, bits,
                                       mins, nulls_last):
        u = encode_orderable(x, dt)
        mn = u64_to_signed(mn)
        if nl:
            v = u - mn
            if valid is not None:
                v = torch.where(valid, v, torch.full_like(
                    v, u64_to_signed((1 << b) - 1)))
        else:
            v = u - mn + 1
            if valid is not None:
                v = torch.where(valid, v, torch.zeros_like(v))
        acc = v if acc is None else ((acc << b) | v)
    return acc


def unpack_keys_single_word(packed: torch.Tensor, bits: Sequence[int]
                            ) -> List[torch.Tensor]:
    """Inverse of the packing: each column's offset code, as int64 (the
    u64's bits where a budget is 64)."""
    out = []
    shift = 0
    for b in reversed(list(bits)):
        mask = u64_to_signed((1 << b) - 1)
        out.append((packed >> shift) & mask)
        shift += b
    return list(reversed(out))
