"""The port's plain attention ops and KV write against the JAX reference.

The same numpy inputs go through `dynamo_tpu_torch.ops` (plain PyTorch
versions — what the dispatchers take for CPU tensors), through
`dynamo_tpu.ops.paged_attention` (the XLA reference paths) and through the
Pallas TPU kernels run with `interpret=True`, as the reference's own tests
run them on the CPU. Tolerance 2e-3 in f32: only the softmax summation
order differs between the implementations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import kv_quant as jkv
from dynamo_tpu.ops import paged_attention as jops
from dynamo_tpu.ops.pallas_paged_attention import paged_attention_decode_pallas
from dynamo_tpu.ops.pallas_prefill_attention import (
    paged_prefill_attention_pallas_batched,
)
from dynamo_tpu.ops.pallas_ragged_attention import (
    ragged_paged_attention_pallas,
    ragged_tile_q as jax_ragged_tile_q,
)
from dynamo_tpu_torch.ops import kv_quant as tkv
from dynamo_tpu_torch.ops import paged_attention as tops

TOL = dict(rtol=2e-3, atol=2e-3)
H, KH, D, PS = 4, 2, 32, 8


def _pool(rng, pages):
    return (rng.randn(pages, PS, KH, D).astype(np.float32),
            rng.randn(pages, PS, KH, D).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("lens", [[1, 5, 13, 48], [8, 9, 7, 33]],
                         ids=["len1_partial_cross", "page_straddle"])
def test_decode_plain_matches_reference_and_pallas(lens):
    rng = np.random.RandomState(sum(lens))
    B, P, pages = len(lens), 6, 40
    q = rng.randn(B, H, D).astype(np.float32)
    k, v = _pool(rng, pages)
    tables = rng.randint(0, pages, size=(B, P)).astype(np.int32)
    seq_lens = np.asarray(lens, np.int32)
    got = tops.paged_attention_decode(*_t(q, k, v, tables, seq_lens)).numpy()
    want = np.asarray(jops.paged_attention_decode(*_j(q, k, v, tables, seq_lens)))
    pallas = np.asarray(paged_attention_decode_pallas(
        *_j(q, k, v, tables, seq_lens), interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_decode_empty_lane_behaves_as_length_one():
    """The kernels' contract (the TPU kernel clamps seq_lens to >= 1)."""
    rng = np.random.RandomState(3)
    q = rng.randn(4, H, D).astype(np.float32)  # shapes of the test above: one trace
    k, v = _pool(rng, 40)
    tables = rng.randint(0, 40, size=(4, 6)).astype(np.int32)
    empty, one = np.asarray([0, 4, 0, 9], np.int32), np.asarray([1, 4, 1, 9], np.int32)
    a = tops.paged_attention_decode(*_t(q, k, v, tables, empty))
    b = tops.paged_attention_decode(*_t(q, k, v, tables, one))
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b)
    pallas = np.asarray(paged_attention_decode_pallas(
        *_j(q, k, v, tables, empty), interpret=True))
    np.testing.assert_allclose(a.numpy(), pallas, **TOL)


@pytest.mark.parametrize("starts,reals", [
    ([0, 13, 0], [24, 17, 1]),
    ([40, 0, 7], [48, 33, 48]),
], ids=["short_padded_dummy", "history_three_tiles"])
def test_prefill_plain_matches_reference_and_pallas(starts, reals):
    # one set of shapes for both cases, so the reference side traces once
    T, P = 48, 13
    rng = np.random.RandomState(sum(reals))
    B = len(starts)
    assert max(s + T for s in starts) <= (P - 1) * PS
    pages = B * P + 4
    q = rng.randn(B, T, H, D).astype(np.float32)
    k, v = _pool(rng, pages)
    tables = rng.permutation(pages)[: B * P].reshape(B, P).astype(np.int32)
    starts_a = np.asarray(starts, np.int32)
    totals = (starts_a + np.asarray(reals)).astype(np.int32)
    positions = (starts_a[:, None] + np.arange(T)[None, :]).astype(np.int32)
    got = tops.prefill_attention_batched(
        *_t(q, k, v, positions, tables, totals, starts_a)).numpy()
    want = np.asarray(jops.prefill_attention_batched(
        *_j(q, k, v, positions, tables, totals, starts_a)))
    pallas = np.asarray(paged_prefill_attention_pallas_batched(
        *_j(q, k, v, tables, starts_a, totals), interpret=True))
    for b, real in enumerate(reals):  # padded rows are discarded by callers
        np.testing.assert_allclose(got[b, :real], want[b, :real], **TOL)
        np.testing.assert_allclose(got[b, :real], pallas[b, :real], **TOL)
    assert np.isfinite(got).all()


def _ragged_case(rows, N, R, align, seed):
    """rows: (row_len, ctx_len); each row start aligned to `align`. The
    table width is fixed so that every case has the same shapes and the
    reference side traces once."""
    rng = np.random.RandomState(seed)
    P = 7
    assert max((c + ln + PS - 1) // PS for ln, c in rows) < P
    pages = R * P + 4
    q = rng.randn(N, H, D).astype(np.float32)
    k, v = _pool(rng, pages)
    tables = rng.permutation(pages)[: R * P].reshape(R, P).astype(np.int32)
    row_starts = np.full((R,), N, np.int32)
    row_lens = np.zeros((R,), np.int32)
    ctx_lens = np.zeros((R,), np.int32)
    off = 0
    for r, (ln, ctx) in enumerate(rows):
        row_starts[r], row_lens[r], ctx_lens[r] = off, ln, ctx
        off += -(-ln // align) * align
    assert off <= N
    return q, k, v, tables, row_starts, row_lens, ctx_lens


RAGGED_MIXES = {
    "mixed": [(24, 7), (1, 13), (1, 40), (9, 0), (1, 1), (17, 31)],
    "page_straddle": [(1, 7), (1, 8), (1, 9), (5, 15), (11, 16), (3, 17)],
}


@pytest.mark.parametrize("name", sorted(RAGGED_MIXES))
def test_ragged_plain_matches_reference_and_pallas(name):
    rows = RAGGED_MIXES[name]
    align = jax_ragged_tile_q(jnp.float32)  # the TPU kernel needs aligned rows
    args = _ragged_case(rows, N=128, R=8, align=align, seed=len(rows))
    got = tops.ragged_attention(*_t(*args)).numpy()
    want = np.asarray(jops.ragged_attention_reference(*_j(*args)))
    pallas = np.asarray(ragged_paged_attention_pallas(*_j(*args), interpret=True))
    assert np.isfinite(got).all()
    for start, ln in zip(args[4], args[5]):
        if ln:
            np.testing.assert_allclose(got[start:start + ln], want[start:start + ln], **TOL)
            np.testing.assert_allclose(got[start:start + ln], pallas[start:start + ln], **TOL)


def test_ragged_dense_packing_and_padding_tokens():
    """The port's kernel needs no row alignment (`ragged_tile_q()` is 1):
    a densely packed buffer gives each row the same values as an aligned
    one, and tokens outside every row come back as zeros."""
    assert tops.ragged_tile_q(torch.bfloat16) == 1
    rows = RAGGED_MIXES["mixed"]
    dense = _ragged_case(rows, N=128, R=8, align=1, seed=5)
    want = np.asarray(jops.ragged_attention_reference(*_j(*dense)))
    got = tops.ragged_attention(*_t(*dense)).numpy()
    used = 0
    for start, ln in zip(dense[4], dense[5]):
        if ln:
            np.testing.assert_allclose(got[start:start + ln], want[start:start + ln], **TOL)
            used = max(used, start + ln)
    assert used < 128 and not got[used:].any()


def test_kv_write_matches_reference_and_is_in_place():
    rng = np.random.RandomState(4)
    L, pages = 2, 6
    store = rng.randn(L, pages, PS, KH, D).astype(np.float32)
    phys = np.asarray([[1, 1, 2], [5, 0, 3]], np.int32)
    offs = np.asarray([[0, 7, 3], [2, 2, 6]], np.int32)
    vals = rng.randn(2, 3, KH, D).astype(np.float32)
    want = np.asarray(jkv.kv_write(jnp.asarray(store), 1, *_j(phys, offs, vals)))
    t_store = torch.from_numpy(store.copy())
    out = tkv.kv_write(t_store, 1, *_t(phys, offs, vals))
    assert out is t_store  # written in place, same tensor returned
    np.testing.assert_array_equal(t_store.numpy(), want)
    assert tkv.kv_page_size(t_store) == PS == jkv.kv_page_size(jnp.asarray(store))
    np.testing.assert_array_equal(tkv.kv_layer(t_store, 0).numpy(), store[0])


def test_only_the_full_precision_kv_format_is_ported():
    """The formats the port stores are the reference's three: full
    precision by default, int8/int4 on request (tests/test_torch_kv_quant.py
    holds them to the reference); an unknown mode and an int4 pool with an
    odd page size are refused."""
    assert tkv.resolve_kv_quant(None) == "none"
    assert tkv.KV_QUANT_MODES == jkv.KV_QUANT_MODES
    with pytest.raises(ValueError):
        tkv.resolve_kv_quant("fp3")
    with pytest.raises(ValueError):
        tkv.alloc_kv_store(1, 2, PS, KH, D, torch.float32, "fp3", device="cpu")
    with pytest.raises(ValueError, match="even"):
        tkv.alloc_kv_store(1, 2, PS + 1, KH, D, torch.float32, "int4", device="cpu")


def test_plain_versions_count_their_calls():
    before = dict(tops.plain_calls)
    rng = np.random.RandomState(0)
    q = rng.randn(1, H, D).astype(np.float32)
    k, v = _pool(rng, 4)
    tops.paged_attention_decode(*_t(q, k, v, np.zeros((1, 2), np.int32),
                                    np.asarray([3], np.int32)))
    assert tops.plain_calls["decode"] == before["decode"] + 1


@pytest.mark.parametrize("B,KH,max_pages,page_size,sms,want", [
    (64, 8, 128, 64, 132, (8, 16)),  # the engine's decode shape: 512-key splits
    (4, 8, 128, 64, 132, (8, 16)),  # few long lanes: the same plan
    (6, 2, 130, 8, 132, (64, 3)),  # tiny pages: 64 pages make 512 keys
    (5, 2, 6, 8, 132, (6, 1)),  # a short table: one split
    (1024, 8, 512, 16, 132, (497, 2)),  # many lanes: splits grow
], ids=["engine", "long_lanes", "tiny_pages", "one_split", "items_capped"])
def test_decode_split_plan(B, KH, max_pages, page_size, sms, want):
    """The decode kernel's split plan, made on the host from shapes only."""
    from dynamo_tpu_torch.ops import hopper_paged_attention as hp

    split_pages, n_splits = hp.split_plan(B, KH, max_pages, page_size, sms)
    assert (split_pages, n_splits) == want
    # every table column lies in a split, and the last split is not empty
    assert (n_splits - 1) * split_pages < max_pages <= n_splits * split_pages
    assert n_splits == 1 or split_pages * page_size >= hp.SPLIT_MIN_KEYS
    assert B * KH * max_pages / split_pages <= hp.ITEMS_PER_SM * sms or n_splits == 1


@pytest.mark.parametrize("B,KH,max_pages,page_size,want", [
    (64, 8, 128, 64, (16, 8)),  # the local block's decode shape: 512-key splits
    (6, 2, 130, 8, (3, 64)),  # tiny pages: three splits
    (5, 2, 6, 8, (1, 6)),  # a short table: one split, no scratch
], ids=["engine", "tiny_pages", "one_split"])
def test_local_decode_plans_with_the_decode_kernel(monkeypatch, B, KH, max_pages, page_size,
                                                   want):
    """The local decode wrapper plans its splits and takes its scratch
    through paged_decode's `split_args` (shapes only), so the two kernels
    share one stream's scratch and arrival counters."""
    import torch

    from dynamo_tpu_torch.ops import hopper_paged_attention as hp
    from dynamo_tpu_torch.ops import hopper_paged_attention_local as hpl

    assert hpl.split_args is hp.split_args
    monkeypatch.setattr(hp, "_sms", lambda device: 132)
    monkeypatch.setattr(hp, "_plans", {})
    monkeypatch.setattr(hp, "_scratch", {})
    dev = torch.device("cpu")
    H, D = 3 * KH, 16
    n_splits, split_pages, ws_o, ws_ml, counters, sms = hp.split_args(
        dev, 7, B, H, KH, D, max_pages, page_size)
    assert (n_splits, split_pages, sms) == (*want, 132)
    assert (split_pages, n_splits) == hp.split_plan(B, KH, max_pages, page_size, 132)
    if n_splits == 1:
        assert ws_o is ws_ml is counters is None and not hp._scratch
        return
    ws, cnt = hp._scratch[(None, 7)]
    rows = B * H * n_splits
    assert ws_o == ws.data_ptr() and ws_ml == ws_o + 4 * rows * D
    assert ws.numel() >= rows * (D + 2) and counters == cnt.data_ptr() and not cnt.any()
    # a second call on the stream (either kernel) reuses the same scratch
    assert hp.split_args(dev, 7, B, H, KH, D, max_pages, page_size)[2:5] == (
        ws_o, ws_ml, counters)
    with pytest.raises(ValueError, match="column"):
        hp.split_args(dev, 7, B, H, KH, D, 0, page_size)


def test_decode_scratch_is_kept_per_stream_and_grows():
    """The decode wrapper's scratch: one (partials, arrival counters) pair a
    stream, reused while it is large enough, grown with counters at zero."""
    import torch

    from dynamo_tpu_torch.ops import hopper_paged_attention as hp

    dev = torch.device("cpu")
    saved = dict(hp._scratch)
    try:
        hp._scratch.clear()
        ws, cnt = hp._scratch_for(dev, 7, 100, 8)
        assert ws.numel() >= 100 and ws.dtype == torch.float32
        assert cnt.numel() >= 8 and cnt.dtype == torch.int32 and not cnt.any()
        again = hp._scratch_for(dev, 7, 50, 4)
        assert again[0] is ws and again[1] is cnt
        other = hp._scratch_for(dev, 8, 50, 4)
        assert other[0] is not ws and other[1] is not cnt
        grown = hp._scratch_for(dev, 7, 200, 16)
        assert grown[0].numel() >= 200 and grown[1].numel() >= 16 and not grown[1].any()
    finally:
        hp._scratch.clear()
        hp._scratch.update(saved)
