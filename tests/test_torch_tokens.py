"""The port's block hashes against the reference's, bit for bit.

`dynamo_tpu_torch.llm.tokens` computes XXH3-64 in pure Python; the KV
router indexes the hashes a worker publishes, so a port worker's values
must be the reference's (`dynamo_tpu.llm.tokens`, xxhash / the native
core) for every input length and seed.
"""

import random
import struct

import numpy as np
import pytest
import xxhash

from dynamo_tpu.llm import tokens as ref
from dynamo_tpu_torch.llm import tokens as port

LENGTHS = list(range(0, 301)) + [1024, 1025, 2048, 4096]
SEEDS = [0, 1, 1 << 63, (1 << 64) - 1, 0x9E3779B97F4A7C15, 12345678901234567]


@pytest.mark.parametrize("seed", SEEDS, ids=lambda s: f"seed{s:x}")
def test_xxh3_equals_xxhash_at_every_length(seed):
    """Every byte length 0..300 (the short, 17-128, 129-240 and long paths
    and their edges), plus several 1024-byte blocks of stripes."""
    rng = random.Random(seed)
    for n in LENGTHS:
        data = bytes(rng.randrange(256) for _ in range(n))
        assert port.xxh3_64(data, seed) == xxhash.xxh3_64_intdigest(data, seed=seed), n


@pytest.mark.parametrize("seed", [0, 1, 1 << 63, 77])
def test_compute_block_hash_equals_xxhash(seed):
    """Token blocks of 0..75 tokens (0..300 bytes) and 256/1024 tokens."""
    rng = np.random.RandomState(seed & 0xFFFF)
    for n_tok in list(range(0, 76)) + [256, 1024]:
        toks = rng.randint(0, 2**31, size=n_tok).tolist()
        data = struct.pack(f"<{n_tok}I", *toks)
        want = xxhash.xxh3_64_intdigest(data, seed=seed)
        assert port.compute_block_hash(toks, seed) == want == ref.compute_block_hash(toks, seed)


def test_block_hash_masks_tokens_and_parent():
    """Negative ids wrap to u32 and the parent to u64, as in the reference."""
    toks = [-1, 2**32 + 5, 7]
    for parent in (-1, 2**64 + 3, 0):
        assert port.compute_block_hash(toks, parent) == ref.compute_block_hash(toks, parent)


@pytest.mark.parametrize("salt", [b"", b"model-a", bytes(range(64)), bytes(300)])
def test_salt_hash_equals_reference(salt):
    assert port.salt_hash(salt) == ref.salt_hash(salt)


@pytest.mark.parametrize("block_size", [8, 16, 64])
def test_compute_seq_hashes_equals_reference(block_size):
    rng = np.random.RandomState(block_size)
    for trial in range(4):
        n = int(rng.randint(0, 6 * block_size))
        toks = rng.randint(0, 128256, size=n).tolist()
        salt = int(rng.randint(0, 2**62)) * 3 if trial else 0
        assert port.compute_seq_hashes(toks, block_size, salt) == \
            ref.compute_seq_hashes(toks, block_size, salt), (trial, n)


def test_token_block_sequence_equals_reference():
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 5000, size=200).tolist()
    a = port.TokenBlockSequence(toks[:100], block_size=16, salt=5)
    b = ref.TokenBlockSequence(toks[:100], block_size=16, salt=5)
    a.extend(toks[100:])
    b.extend(toks[100:])
    assert a.block_hashes() == b.block_hashes() and len(a.blocks) == 12
    a.truncate(70)
    b.truncate(70)
    assert a.block_hashes() == b.block_hashes() and a.partial_tokens == b.partial_tokens
