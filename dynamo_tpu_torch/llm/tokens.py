"""Token block hashing — the shared currency of KV reuse.

Port of `dynamo_tpu/llm/tokens.py`: tokens are grouped into fixed-size
blocks; each block's hash chains the parent block's hash, giving a
sequence hash that identifies the exact prefix ending at that block. The
engine's prefix cache keys pages on these hashes, and the KV router's
index keys on the same values from the worker's KV events, so they must
equal the reference's bit for bit.

Hash: xxh3_64(le_bytes(tokens), seed=parent_hash) — parent of the first
block is the salt hash (xxh3_64 of the salt bytes, seed 0). XXH3-64 is
written out here in pure Python (standard library only): the short paths
(0-16 bytes), the 17-128 and 129-240 byte paths, and the long path (more
than 240 bytes: 64-byte stripes accumulated into eight lanes, scrambled
every 1024 bytes, with a secret derived from the seed). A 64-token block
is 256 bytes, so every served page size of 64 takes the long path.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence

DEFAULT_BLOCK_SIZE = 64
NULL_PARENT = 0
_MASK64 = 0xFFFFFFFFFFFFFFFF


_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5
_PMX_1 = 0x165667919E3779F9
_PMX_2 = 0x9FB21C651E98DF25

# XXH3's default 192-byte secret (kSecret of the xxHash sources)
_K_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)
_K_WORDS = struct.unpack("<24Q", _K_SECRET)
_STRIPE = 64
_BLOCK = 1024  # 16 stripes of 64 bytes between two scrambles (192-byte secret)
_INIT_ACC = (_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1)


def _u64(b: bytes, off: int) -> int:
    return int.from_bytes(b[off:off + 8], "little")


def _u32(b: bytes, off: int) -> int:
    return int.from_bytes(b[off:off + 4], "little")


def _fold64(a: int, b: int) -> int:
    """mul128_fold64: the 128-bit product's halves XORed together."""
    p = a * b
    return (p ^ (p >> 64)) & _MASK64


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX_1) & _MASK64
    return h ^ (h >> 32)


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _MASK64
    h ^= h >> 29
    h = (h * _P64_3) & _MASK64
    return h ^ (h >> 32)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _mix16(data: bytes, off: int, sec: bytes, soff: int, seed: int) -> int:
    lo = _u64(data, off) ^ ((_u64(sec, soff) + seed) & _MASK64)
    hi = _u64(data, off + 8) ^ ((_u64(sec, soff + 8) - seed) & _MASK64)
    return _fold64(lo, hi)


def _xxh3_short(data: bytes, n: int, seed: int) -> int:
    s = _K_SECRET
    if n > 8:  # 9-16 bytes
        lo = _u64(data, 0) ^ (((_u64(s, 24) ^ _u64(s, 32)) + seed) & _MASK64)
        hi = _u64(data, n - 8) ^ (((_u64(s, 40) ^ _u64(s, 48)) - seed) & _MASK64)
        swapped = int.from_bytes(lo.to_bytes(8, "little"), "big")
        return _avalanche((n + swapped + hi + _fold64(lo, hi)) & _MASK64)
    if n >= 4:
        seed ^= int.from_bytes((seed & 0xFFFFFFFF).to_bytes(4, "little"), "big") << 32
        flip = ((_u64(s, 8) ^ _u64(s, 16)) - seed) & _MASK64
        h = (_u32(data, n - 4) + (_u32(data, 0) << 32)) ^ flip
        h ^= _rotl(h, 49) ^ _rotl(h, 24)
        h = (h * _PMX_2) & _MASK64
        h ^= (h >> 35) + n
        h = (h * _PMX_2) & _MASK64
        return h ^ (h >> 28)
    if n:  # 1-3 bytes
        combined = (data[0] << 16) | (data[n >> 1] << 24) | data[n - 1] | (n << 8)
        flip = ((_u32(s, 0) ^ _u32(s, 4)) + seed) & _MASK64
        return _xxh64_avalanche(combined ^ flip)
    return _xxh64_avalanche(seed ^ _u64(s, 56) ^ _u64(s, 64))


def _xxh3_mid(data: bytes, n: int, seed: int) -> int:
    s = _K_SECRET
    acc = (n * _P64_1) & _MASK64
    if n <= 128:
        for i in range((n - 1) // 32, -1, -1):  # pairs from both ends
            acc += _mix16(data, 16 * i, s, 32 * i, seed)
            acc += _mix16(data, n - 16 * (i + 1), s, 32 * i + 16, seed)
        return _avalanche(acc & _MASK64)
    for i in range(8):
        acc += _mix16(data, 16 * i, s, 16 * i, seed)
    acc = _avalanche(acc & _MASK64)
    for i in range(8, n // 16):
        acc += _mix16(data, 16 * i, s, 16 * (i - 8) + 3, seed)
    acc += _mix16(data, n - 16, s, 136 - 17, seed)
    return _avalanche(acc & _MASK64)


def _accumulate(acc: list, words, w0: int, sec_words) -> None:
    """One 64-byte stripe (words[w0:w0+8]) into the eight lanes."""
    for i in range(8):
        v = words[w0 + i]
        k = v ^ sec_words[i]
        acc[i ^ 1] += v
        acc[i] = (acc[i] + (k & 0xFFFFFFFF) * (k >> 32)) & _MASK64


def _xxh3_long(data: bytes, n: int, seed: int) -> int:
    if seed:  # the secret derived from the seed (XXH3_initCustomSecret)
        sw = [
            (w + seed if i % 2 == 0 else w - seed) & _MASK64
            for i, w in enumerate(_K_WORDS)
        ]
        sec = struct.pack("<24Q", *sw)
    else:
        sw, sec = _K_WORDS, _K_SECRET
    words = struct.unpack_from(f"<{n // 8}Q", data)
    acc = list(_INIT_ACC)
    scramble = struct.unpack_from("<8Q", sec, 192 - _STRIPE)
    n_blocks = (n - 1) // _BLOCK
    for b in range(n_blocks):
        for st in range(_BLOCK // _STRIPE):
            _accumulate(acc, words, (b * _BLOCK + st * _STRIPE) // 8, sw[st:st + 8])
        for i in range(8):
            a = acc[i] & _MASK64
            a ^= a >> 47
            acc[i] = ((a ^ scramble[i]) * _P32_1) & _MASK64
    for st in range(((n - 1) - _BLOCK * n_blocks) // _STRIPE):
        _accumulate(acc, words, (n_blocks * _BLOCK + st * _STRIPE) // 8, sw[st:st + 8])
    last = struct.unpack_from("<8Q", data, n - _STRIPE)
    _accumulate(acc, last, 0, struct.unpack_from("<8Q", sec, 192 - _STRIPE - 7))
    for i in range(8):
        acc[i] &= _MASK64
    merge = struct.unpack_from("<8Q", sec, 11)
    h = (n * _P64_1) & _MASK64
    for i in range(4):
        h += _fold64(acc[2 * i] ^ merge[2 * i], acc[2 * i + 1] ^ merge[2 * i + 1])
    return _avalanche(h & _MASK64)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3-64 of `data` with a 64-bit seed (xxhash's `xxh3_64_intdigest`)."""
    seed &= _MASK64
    n = len(data)
    if n <= 16:
        return _xxh3_short(data, n, seed)
    if n <= 240:
        return _xxh3_mid(data, n, seed)
    return _xxh3_long(data, n, seed)


def salt_hash(salt: bytes = b"") -> int:
    """Per-model/per-tenant salt: the parent of a sequence's first block."""
    return xxh3_64(salt, 0)


def compute_block_hash(tokens: Sequence[int], parent_hash: int = NULL_PARENT) -> int:
    """Chained block hash: xxh3_64 of the block's tokens seeded by its parent."""
    data = struct.pack(f"<{len(tokens)}I", *[t & 0xFFFFFFFF for t in tokens])
    return xxh3_64(data, parent_hash)


def compute_seq_hashes(
    tokens: Sequence[int],
    block_size: int = DEFAULT_BLOCK_SIZE,
    salt: int = NULL_PARENT,
) -> List[int]:
    """Sequence hashes of every COMPLETE block of `tokens`."""
    hashes: List[int] = []
    parent = salt
    for start in range(0, len(tokens) - block_size + 1, block_size):
        parent = compute_block_hash(tokens[start : start + block_size], parent)
        hashes.append(parent)
    return hashes


@dataclass
class TokenBlock:
    """One complete block with its chained hash (reference TokenBlock)."""

    tokens: List[int]
    block_hash: int
    parent_hash: int
    position: int  # block index in the sequence


class TokenBlockSequence:
    """Incrementally maintained blocked token sequence
    (reference TokenBlockSequence).

    Supports append (token-at-a-time or extend) while keeping complete-block
    hashes chained; used by engine-side KV bookkeeping and the mocker.
    """

    def __init__(
        self,
        tokens: Optional[Iterable[int]] = None,
        block_size: int = DEFAULT_BLOCK_SIZE,
        salt: int = NULL_PARENT,
    ):
        self.block_size = block_size
        self.salt = salt
        self.blocks: List[TokenBlock] = []
        self._partial: List[int] = []
        if tokens:
            self.extend(tokens)

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self._partial)

    @property
    def tokens(self) -> List[int]:
        out: List[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self._partial)
        return out

    @property
    def partial_tokens(self) -> List[int]:
        return list(self._partial)

    def block_hashes(self) -> List[int]:
        return [b.block_hash for b in self.blocks]

    def last_hash(self) -> int:
        return self.blocks[-1].block_hash if self.blocks else self.salt

    def append(self, token: int):
        self._partial.append(token)
        if len(self._partial) == self.block_size:
            parent = self.last_hash()
            h = compute_block_hash(self._partial, parent)
            self.blocks.append(
                TokenBlock(self._partial, h, parent, len(self.blocks))
            )
            self._partial = []

    def extend(self, tokens: Iterable[int]):
        for t in tokens:
            self.append(t)

    def truncate(self, num_tokens: int):
        """Drop tokens beyond `num_tokens` (used when a migrated request is sent again)."""
        if num_tokens >= len(self):
            return
        all_tokens = self.tokens[:num_tokens]
        self.blocks = []
        self._partial = []
        self.extend(all_tokens)
