"""Token block hashing — the shared currency of KV reuse.

Port of `dynamo_tpu/llm/tokens.py`: tokens are grouped into fixed-size
blocks; each block's hash chains the parent block's hash, giving a
sequence hash that identifies the exact prefix ending at that block. The
engine's prefix cache keys pages on these hashes.

Hash: a 64-bit BLAKE2b digest of le_bytes(tokens) keyed by the parent
hash (standard library only). The reference uses xxh3_64 seeded by the
parent; hash VALUES therefore differ from the reference's, prefix-cache
BEHAVIOUR (which blocks hit) does not. Values identical to the router's
are needed only once the KV router is ported.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence

DEFAULT_BLOCK_SIZE = 64
NULL_PARENT = 0
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _hash64(data: bytes, seed: int) -> int:
    key = struct.pack("<Q", seed & _MASK64)
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8, key=key).digest(), "little"
    )


def salt_hash(salt: bytes = b"") -> int:
    """Per-model/per-tenant salt: the parent of a sequence's first block."""
    return _hash64(salt, 0)


def compute_block_hash(tokens: Sequence[int], parent_hash: int = NULL_PARENT) -> int:
    """Chained block hash: digest of the block's tokens keyed by its parent."""
    data = struct.pack(f"<{len(tokens)}I", *[t & 0xFFFFFFFF for t in tokens])
    return _hash64(data, parent_hash)


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
