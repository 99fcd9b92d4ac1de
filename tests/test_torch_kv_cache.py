"""The port's page allocator and block hashing against the reference.

One scripted sequence of acquire/alloc/commit/release/evict goes through
both `PageAllocator`s: page ids, event kinds and the run structure of the
stored events must be the same. Hash VALUES differ by design (the port
hashes with the standard library, the reference with xxh3), so the script
feeds each allocator its own package's hashes of the same tokens.
"""

import numpy as np
import pytest
import torch

from dynamo_tpu.engine.kv_cache import PageAllocator as JaxAllocator
from dynamo_tpu.llm import tokens as jtok
from dynamo_tpu_torch.engine.kv_cache import PageAllocator, alloc_kv_arrays
from dynamo_tpu_torch.llm import tokens as ttok
from dynamo_tpu_torch.llm.mocker.kv_manager import KvEvent, stored_event_runs
from dynamo_tpu_torch.llm.tokenizers import ByteTokenizer

PS = 4


def _script(alloc_cls, tok_mod):
    """Run the scripted trace; return the observable outcome."""
    events = []
    alloc = alloc_cls(10, PS, event_sink=events.append)
    rng = np.random.RandomState(0)
    seq_a = rng.randint(0, 1000, size=16).tolist()
    seq_b = seq_a[:8] + rng.randint(0, 1000, size=8).tolist()  # shares 2 blocks
    seq_c = rng.randint(0, 1000, size=24).tolist()
    h = {n: tok_mod.compute_seq_hashes(s, PS) for n, s in
         (("a", seq_a), ("b", seq_b), ("c", seq_c))}
    blocks = lambda s: [s[i:i + PS] for i in range(0, len(s), PS)]  # noqa: E731
    log = []
    # A: miss, allocate 4 fresh, commit, release (-> LRU cached)
    log.append(("a_cached", alloc.acquire_cached(h["a"])))
    pa = alloc.alloc_fresh(4)
    log.append(("a_fresh", list(pa)))
    alloc.commit_hashes(pa, h["a"], blocks(seq_a), None)
    alloc.release(pa, h["a"])
    log.append(("free_after_a", alloc.free_pages, alloc.used_pages, alloc.active_pages))
    # B: hits A's first two blocks, allocates the rest; commit with a gap
    hit = alloc.acquire_cached(h["b"])
    log.append(("b_hit", list(hit), alloc.prefix_hit_blocks_total))
    pb = alloc.alloc_fresh(2)
    log.append(("b_fresh", list(pb)))
    alloc.commit_hashes(hit + pb, h["b"], blocks(seq_b), None)
    # C: needs 6 pages -> evicts A's unreferenced blocks in LRU order
    log.append(("can_c", alloc.can_allocate(6), alloc.can_allocate(7)))
    pc = alloc.alloc_fresh(6)
    log.append(("c_fresh", list(pc)))
    log.append(("c_too_many", alloc.alloc_fresh(1)))
    alloc.commit_hashes(pc[:3], h["c"][:3], blocks(seq_c)[:3], None)
    alloc.release(pc, h["c"][:3])
    alloc.release(hit + pb, h["b"])
    log.append(("cached_b", alloc.cached_prefix(h["b"])))
    log.append(("cleared", alloc.clear_cache()))
    log.append(("stats", sorted(alloc.stats().items())))
    # events: kinds + run structure, with hashes renamed to their identity
    names = {}
    for n, hs in h.items():
        for i, x in enumerate(hs):
            names.setdefault(x, f"{n}{i}")
    shape = [
        (e.event_type, [names[x] for x in e.block_hashes],
         names.get(e.parent_hash), e.token_blocks)
        for e in events
    ]
    return log, shape


def test_scripted_trace_gives_same_pages_and_events():
    want_log, want_events = _script(JaxAllocator, jtok)
    got_log, got_events = _script(PageAllocator, ttok)
    assert got_log == want_log
    assert got_events == want_events
    kinds = [e[0] for e in got_events]
    assert "stored" in kinds and "removed" in kinds


def test_stored_event_runs_split_at_gaps():
    runs = stored_event_runs([1, 2, 3, 4, 5], {1, 2, 4}, [[1], [2], [3], [4], [5]], 0)
    assert [(e.block_hashes, e.parent_hash, e.token_blocks) for e in runs] == [
        ([1, 2], 0, [[1], [2]]), ([4], 3, [[4]])]
    assert KvEvent("removed", [9]).to_dict() == {"event_type": "removed", "block_hashes": [9]}


@pytest.mark.parametrize("mod", [ttok, jtok], ids=["port", "reference"])
def test_seq_hash_chain_properties(mod):
    """Properties the prefix cache relies on, for both hash functions."""
    rng = np.random.RandomState(1)
    toks = rng.randint(0, 50000, size=70).tolist()
    hs = mod.compute_seq_hashes(toks, 16)
    assert len(hs) == 4 and len(set(hs)) == 4  # complete blocks only
    assert all(0 <= x < 2**64 for x in hs)
    # prefix-stable: a longer sequence keeps the hashes of the shared prefix
    assert mod.compute_seq_hashes(toks + [1] * 40, 16)[:4] == hs
    # chained: changing an early token changes every later hash
    other = mod.compute_seq_hashes([toks[0] + 1] + toks[1:], 16)
    assert all(a != b for a, b in zip(hs, other))
    # a change in block 2 leaves blocks 0-1 alone
    late = mod.compute_seq_hashes(toks[:40] + [toks[40] + 1] + toks[41:], 16)
    assert late[:2] == hs[:2] and late[2] != hs[2] and late[3] != hs[3]
    # salt-separated
    salted = mod.compute_seq_hashes(toks, 16, salt=mod.salt_hash(b"adapter-a"))
    assert all(a != b for a, b in zip(hs, salted))
    assert mod.salt_hash(b"adapter-a") != mod.salt_hash(b"adapter-b")
    # the incremental sequence agrees with the one-shot hashes
    seq = mod.TokenBlockSequence(toks[:20], 16)
    seq.extend(toks[20:])
    assert seq.block_hashes() == hs and len(seq) == 70 and seq.tokens == toks
    seq.truncate(33)
    assert seq.block_hashes() == hs[:2] and len(seq.partial_tokens) == 1


def test_alloc_kv_arrays_layout():
    k, v = alloc_kv_arrays(2, 5, 8, 2, 16, dtype=torch.float32, device="cpu")
    assert k.shape == v.shape == (2, 5, 8, 2, 16)
    assert k.dtype == torch.float32 and not k.any() and k.data_ptr() != v.data_ptr()


def test_byte_tokenizer_round_trip_and_stream():
    tok = ByteTokenizer(512)
    text = "paged attention — naïve ✓"
    ids = tok.encode(text)
    assert tok.decode(ids) == text and tok.vocab_size == 512
    assert tok.eos_token_ids == [2] and tok.bos_token_id == 1
    stream = tok.decode_stream()
    out = "".join(filter(None, (stream.step(i) for i in ids)))
    assert out == text
    assert tok.decode([300]) == chr(0x100 + 300 - 259)
