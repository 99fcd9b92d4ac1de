"""The port's plain decode, prefill and ragged attention against the JAX
reference in bf16, at a query-head grouping that is not a power of two
(H=6, KH=2: G=3).

The plain versions are what the CPU takes and what the card's kernels are
held to, and the engine serves bf16, so they are checked here at the
engine's dtype. The same numpy inputs, rounded to bf16 on each side, go
through `dynamo_tpu_torch.ops.paged_attention` and through the reference's
XLA paths (`paged_attention_decode` and `paged_attention_decode_mixed` over
bf16, int8 and int4 pools, `prefill_attention_batched`,
`ragged_attention_reference`). Tolerance 5e-2
absolute, the bf16 tolerance
of the reference's own kernel tests: the two round probabilities and
outputs to bf16 at the same places but sum in other orders. One set of
shapes per function, so the reference side traces once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import kv_quant as jkv
from dynamo_tpu.ops import paged_attention as jops
from dynamo_tpu_torch.ops import kv_quant as tkv
from dynamo_tpu_torch.ops import paged_attention as tops

ATOL = 5e-2
H, KH, D, PS = 6, 2, 16, 8


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _bf16_pair(*arrays):
    """The float arrays as bf16 torch tensors and bf16 jax arrays."""
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrays],
            [jnp.asarray(a, jnp.bfloat16) for a in arrays])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _pool_pair(rng, fmt, pages):
    """One pool (K or V) for both packages: bf16 values, or random ints with
    positive scales (int4 two keys to a byte row) and some fresh pages."""
    if fmt == "none":
        x = rng.randn(pages, PS, KH, D).astype(np.float32)
        return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)
    bits = tkv.kv_quant_bits(fmt)
    rows = PS // 2 if bits == 4 else PS
    q = rng.randint(-128, 128, size=(pages, rows, KH, D)).astype(np.int8)
    s = (rng.rand(pages, KH) * 0.02).astype(np.float32)
    s[::5] = 0.0
    return (tkv.QuantKV(*_t(q, s), bits, PS),
            jkv.QuantKV(jnp.asarray(q), jnp.asarray(s), bits, PS))


# an empty lane, a length-1 lane, page-straddling lanes, a full table
DECODE_LENS = [0, 1, 9, 17, 37, 48]


@pytest.mark.parametrize("fmt", ["none", "int8", "int4"])
def test_decode_plain_bf16_g3_matches_reference(fmt):
    B, P, pages = len(DECODE_LENS), 6, 24
    rng = np.random.RandomState(7)
    q = rng.randn(B, H, D).astype(np.float32)
    (tk, jk), (tv, jv) = _pool_pair(rng, fmt, pages), _pool_pair(rng, fmt, pages)
    tables = rng.randint(0, pages, size=(B, P)).astype(np.int32)
    lens = np.asarray(DECODE_LENS, np.int32)
    (tq,), (jq,) = _bf16_pair(q)
    got = tops.paged_attention_decode_plain(tq, tk, tv, *_t(tables, lens))
    # an empty lane behaves as length 1 (the kernels' contract, the TPU
    # kernel's clamp); the reference's XLA path is handed that length
    want = jops.paged_attention_decode(jq, jk, jv, *_j(tables, np.maximum(lens, 1)))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = _f32(got), _f32(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# pool lengths of the local decode block: empty pools (they attend no pool
# key, in the port and in the reference's XLA path alike), a one-key pool,
# page-straddling pools, a full table
MIXED_POOL_LENS = [0, 1, 8, 17, 0, 48]


@pytest.mark.parametrize("step", [0, 3], ids=["first_step", "last_step"])
@pytest.mark.parametrize("fmt", ["none", "int8", "int4"])
def test_decode_mixed_plain_bf16_g3_matches_reference(fmt, step):
    """The local decode block's plain attention (pool plus K=4 block-local
    rows, one softmax) against the reference's XLA path in bf16: what the
    card's local kernel is held to. Rows past step_idx hold garbage."""
    B, P, pages, K = len(MIXED_POOL_LENS), 6, 24, 4
    rng = np.random.RandomState(11)
    q = rng.randn(B, H, D).astype(np.float32)
    (tk, jk), (tv, jv) = _pool_pair(rng, fmt, pages), _pool_pair(rng, fmt, pages)
    tables = rng.randint(0, pages, size=(B, P)).astype(np.int32)
    pool_lens = np.asarray(MIXED_POOL_LENS, np.int32)
    loc_k = rng.randn(B, K, KH, D).astype(np.float32)
    loc_v = rng.randn(B, K, KH, D).astype(np.float32)
    loc_k[:, step + 1:] = 1e4
    loc_v[:, step + 1:] = 1e4
    (tq, tlk, tlv), (jq, jlk, jlv) = _bf16_pair(q, loc_k, loc_v)
    got = tops.paged_attention_decode_mixed_plain(
        tq, tk, tv, *_t(tables, pool_lens), tlk, tlv, torch.tensor([step], dtype=torch.int32))
    want = jops.paged_attention_decode_mixed(
        jq, jk, jv, *_j(tables, pool_lens), jlk, jlv, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = _f32(got), _f32(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("starts,reals", [
    ([0, 13, 0], [24, 17, 1]),
    ([40, 0, 7], [24, 9, 20]),
], ids=["short_padded_dummy", "history_page_straddle"])
def test_prefill_plain_bf16_g3_matches_reference(starts, reals):
    T, P, B = 24, 9, 3
    rng = np.random.RandomState(sum(reals) + 100)
    assert max(s + T for s in starts) <= P * PS
    pages = B * P + 3
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(pages, PS, KH, D).astype(np.float32)
    v = rng.randn(pages, PS, KH, D).astype(np.float32)
    tables = rng.permutation(pages)[: B * P].reshape(B, P).astype(np.int32)
    starts_a = np.asarray(starts, np.int32)
    totals = (starts_a + np.asarray(reals)).astype(np.int32)
    positions = (starts_a[:, None] + np.arange(T)[None, :]).astype(np.int32)
    (tq, tk, tv), (jq, jk, jv) = _bf16_pair(q, k, v)
    got = tops.prefill_attention_batched_plain(
        tq, tk, tv, *_t(positions, tables, totals, starts_a))
    want = jops.prefill_attention_batched(jq, jk, jv, *_j(positions, tables, totals, starts_a))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = _f32(got), _f32(want)
    assert np.isfinite(got).all()
    for b, real in enumerate(reals):  # padded rows are discarded by callers
        np.testing.assert_allclose(got[b, :real], want[b, :real], rtol=0, atol=ATOL)


RAGGED_MIXES = {
    "mixed": [(24, 7), (1, 13), (1, 0), (9, 0), (1, 1), (17, 31)],
    "decode_heavy": [(1, 7), (1, 8), (1, 40), (5, 15), (11, 16), (3, 0)],
}


@pytest.mark.parametrize("name", sorted(RAGGED_MIXES))
def test_ragged_plain_bf16_g3_matches_reference(name):
    rows = RAGGED_MIXES[name]
    N, R, P = 64, 8, 7
    assert max(-(-(c + ln) // PS) for ln, c in rows) <= P
    rng = np.random.RandomState(len(name))
    pages = R * P + 3
    q = rng.randn(N, H, D).astype(np.float32)
    k = rng.randn(pages, PS, KH, D).astype(np.float32)
    v = rng.randn(pages, PS, KH, D).astype(np.float32)
    tables = rng.permutation(pages)[: R * P].reshape(R, P).astype(np.int32)
    row_starts = np.full((R,), N, np.int32)
    row_lens = np.zeros((R,), np.int32)
    ctx_lens = np.zeros((R,), np.int32)
    off = 0
    for r, (ln, ctx) in enumerate(rows):  # packed densely, as the port packs
        row_starts[r], row_lens[r], ctx_lens[r] = off, ln, ctx
        off += ln
    idx = (tables, row_starts, row_lens, ctx_lens)
    (tq, tk, tv), (jq, jk, jv) = _bf16_pair(q, k, v)
    got = _f32(tops.ragged_attention_plain(tq, tk, tv, *_t(*idx)))
    want = _f32(jops.ragged_attention_reference(jq, jk, jv, *_j(*idx)))
    assert np.isfinite(got).all() and not got[off:].any()
    for start, ln in zip(row_starts, row_lens):
        if ln:
            np.testing.assert_allclose(got[start:start + ln], want[start:start + ln],
                                       rtol=0, atol=ATOL)
