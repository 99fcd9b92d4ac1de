"""The port's quantized KV cache against the JAX reference, on the CPU.

The same numpy writes go through `dynamo_tpu_torch.ops.kv_quant` and
`dynamo_tpu.ops.kv_quant` (under `jax.jit`, as the reference's engine runs
it): the stored ints and scales must be BIT-EQUAL (f32 values, round half
to even on both sides, int8 wraparound in the delta-add). The quant-aware plain attention versions are held against the
reference's XLA paths (which dequantize through `gather_dequant`) and the
Pallas kernels run with `interpret=True` on `QuantKV` operands, at 2e-3 in
f32: only the softmax summation order differs. The reference has no
quantized prefill kernel, so prefill is held against its XLA path alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import quant as jquant
from dynamo_tpu.ops import kv_quant as jkv
from dynamo_tpu.ops import paged_attention as jops
from dynamo_tpu.ops.pallas_paged_attention import paged_attention_decode_pallas
from dynamo_tpu.ops.pallas_ragged_attention import (
    ragged_paged_attention_pallas,
    ragged_tile_q as jax_ragged_tile_q,
)
from dynamo_tpu_torch.models import quant as tquant
from dynamo_tpu_torch.ops import kv_quant as tkv
from dynamo_tpu_torch.ops import paged_attention as tops

TOL = dict(rtol=2e-3, atol=2e-3)
H, KH, D, PS = 4, 2, 32, 8
MODES = ["int8", "int4"]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _stores(mode, L=2, pages=6, dim=16):
    return (jkv.alloc_kv_store(L, pages, PS, KH, dim, jnp.float32, mode),
            tkv.alloc_kv_store(L, pages, PS, KH, dim, torch.float32, mode, device="cpu"))


def _assert_bit_equal(jstore, tstore):
    np.testing.assert_array_equal(tstore.q.numpy(), np.asarray(jstore.q))
    np.testing.assert_array_equal(tstore.s.numpy(), np.asarray(jstore.s))


# the reference's write, compiled once per format and shape (every write
# below has four tokens)
_jax_write = jax.jit(jkv.kv_write, static_argnums=1)
_jax_write_all = jax.jit(jkv.kv_write_all_layers)

# each scenario: a sequence of four-token writes (phys, offs, value scale)
# into layer 1
WRITES = {
    # small tokens first, then an outlier into the same page: the scale
    # grows and the page's earlier ints are requantized by the ratio
    "scale_growth": [([1, 1, 1, 2], [0, 1, 2, 0], 0.05),
                     ([1, 2, 4, 4], [3, 1, 0, 1], 6.0),
                     ([1, 4, 4, 1], [7, 2, 3, 4], 0.01)],
    # a write at offset 0 of a used page drops its stale scale and ints
    "page_start_reset": [([3, 3, 3, 5], [0, 4, 5, 0], 4.0),
                         ([3, 3, 5, 5], [0, 1, 1, 2], 0.1),
                         ([4, 3, 5, 5], [6, 2, 0, 3], 0.2)],
    # several copies of one page in one write, including both halves of an
    # int4 byte (offsets o and o + 4) and one (page, offset) twice
    "duplicate_pages": [([2, 2, 2, 2], [1, 5, 2, 6], 1.0),
                        ([2, 0, 0, 0], [3, 2, 2, 6], 3.0),
                        ([5, 5, 2, 2], [1, 5, 0, 7], 0.5)],
}


@pytest.mark.parametrize("scenario", sorted(WRITES))
@pytest.mark.parametrize("mode", MODES)
def test_kv_write_bit_equal_to_reference(mode, scenario):
    js, ts = _stores(mode)
    rng = np.random.RandomState(len(scenario))
    for phys, offs, scale in WRITES[scenario]:
        vals = (rng.randn(len(phys), KH, 16) * scale).astype(np.float32)
        ph, of = np.asarray(phys, np.int32), np.asarray(offs, np.int32)
        js = _jax_write(js, 1, *_j(ph, of, vals))
        out = tkv.kv_write(ts, 1, *_t(ph, of, vals))
        assert out is ts  # in place
        _assert_bit_equal(js, ts)
    assert not ts.q[0].any() and not ts.s[0].any()  # layer 0 untouched
    if scenario == "scale_growth":
        # the outlier really grew the page's scale past the first write's
        assert ts.s[1, 1].max() > 6.0 / jquant.QMAX[tkv.kv_quant_bits(mode)]


@pytest.mark.parametrize("mode", MODES)
def test_kv_write_all_layers_bit_equal_to_reference(mode):
    """The local block's commit: [L, B, K] writes, inactive lanes on the
    scratch page, then a second block that grows and resets pages."""
    js, ts = _stores(mode, L=3)
    rng = np.random.RandomState(9)
    blocks = [
        (np.asarray([[1, 1, 1, 2], [0, 0, 0, 0]]), np.asarray([[5, 6, 7, 0], [0, 1, 2, 3]]), 1.0),
        (np.asarray([[2, 2, 2, 2], [3, 3, 4, 4]]), np.asarray([[1, 2, 3, 4], [6, 7, 0, 1]]), 5.0),
    ]
    for phys, offs, scale in blocks:
        vals = (rng.randn(3, *phys.shape, KH, 16) * scale).astype(np.float32)
        js = _jax_write_all(js, *_j(phys, offs, vals))
        assert tkv.kv_write_all_layers(ts, *_t(phys, offs, vals)) is ts
        _assert_bit_equal(js, ts)


def test_pack_unpack_int4_bit_equal_to_reference():
    rng = np.random.RandomState(1)
    vals = rng.randint(-7, 8, size=(3, 8, 2, 5)).astype(np.int8)
    packed = tquant.pack_int4(torch.from_numpy(vals), axis=1)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jquant.pack_int4(vals, axis=1)))
    np.testing.assert_array_equal(tquant.unpack_int4(packed, axis=1).numpy(), vals)
    # every byte, not only packed [-7, 7] pairs: sign extension of both nibbles
    every = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(
        tquant.unpack_int4(torch.from_numpy(every), axis=0).numpy(),
        np.asarray(jquant.unpack_int4(every, axis=0)))
    assert tquant.QMAX == jquant.QMAX


def _random_quant_layer(rng, mode, pages, dim=D):
    """A per-layer quantized pool with arbitrary bytes (int4: any nibble
    pair) and positive scales, some pages fresh (scale 0)."""
    bits = tkv.kv_quant_bits(mode)
    rows = PS // 2 if bits == 4 else PS
    lo = -128 if bits == 4 else -127
    q = rng.randint(lo, 128, size=(pages, rows, KH, dim)).astype(np.int8)
    s = (rng.rand(pages, KH) * 0.05).astype(np.float32)
    s[::5] = 0.0
    return q, s, bits


def _both(q, s, bits):
    return (jkv.QuantKV(jnp.asarray(q), jnp.asarray(s), bits, PS),
            tkv.QuantKV(*_t(q, s), bits, PS))


@pytest.mark.parametrize("mode", MODES)
def test_gather_dequant_bit_equal_to_reference(mode):
    rng = np.random.RandomState(2)
    jl, tl = _both(*_random_quant_layer(rng, mode, 7, dim=16))
    tables = rng.randint(0, 7, size=(3, 4)).astype(np.int32)
    want = np.asarray(jkv.gather_dequant(jl, jnp.asarray(tables)))
    got = tkv.gather_dequant(tl, torch.from_numpy(tables))
    assert got.shape == (3, 4, PS, KH, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    bf = tkv.gather_dequant(tl, torch.from_numpy(tables), torch.bfloat16)
    np.testing.assert_array_equal(
        bf.float().numpy(),
        np.asarray(jkv.gather_dequant(jl, jnp.asarray(tables), jnp.bfloat16), np.float32))


@pytest.mark.parametrize("mode", ["none"] + MODES)
def test_kv_page_bytes_and_store_layout_match_reference(mode):
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        assert (tkv.kv_page_bytes(64, 8, 128, tdt, mode)
                == jkv.kv_page_bytes(64, 8, 128, jdt, mode))
    js, ts = _stores(mode, L=2, pages=5)
    assert tkv.kv_page_size(ts) == jkv.kv_page_size(js) == PS
    if mode == "none":
        assert isinstance(ts, torch.Tensor) and ts.shape == js.shape
        return
    assert ts.mode == js.mode == mode and ts.bits == js.bits
    assert tuple(ts.q.shape) == js.q.shape and ts.q.dtype == torch.int8
    assert tuple(ts.s.shape) == js.s.shape and ts.s.dtype == torch.float32
    assert ts.nbytes == js.nbytes == 2 * 5 * tkv.kv_page_bytes(PS, KH, 16, torch.float32, mode)
    layer = tkv.kv_layer(ts, 1)  # a view: writes through it land in the store
    layer.s[2, 0] = 3.0
    assert ts.s[1, 2, 0] == 3.0 and layer.page_size == PS
    k_raw, _, rows, ps, bits, k_scale, _ = tkv.kernel_operands(layer, layer)
    assert rows == (PS // 2 if mode == "int4" else PS) and ps == PS and bits == ts.bits
    assert k_raw.data_ptr() == ts.q[1].data_ptr() and k_scale.data_ptr() == ts.s[1].data_ptr()


def test_kv_quant_mode_resolution(monkeypatch):
    monkeypatch.setenv("DYN_KV_QUANT", "INT4")
    assert tkv.resolve_kv_quant(None) == jkv.resolve_kv_quant(None) == "int4"
    assert tkv.resolve_kv_quant("int8") == "int8"  # explicit beats the environment
    monkeypatch.delenv("DYN_KV_QUANT")
    assert tkv.resolve_kv_quant(None) == "none"
    with pytest.raises(ValueError):
        tkv.resolve_kv_quant("fp8")
    with pytest.raises(ValueError, match="even"):
        tkv.alloc_kv_store(1, 2, 7, KH, D, torch.float32, "int4", device="cpu")


# ---------------------------------------------------------------------- #
# quant-aware plain attention vs the reference's XLA paths and Pallas kernels
# ---------------------------------------------------------------------- #

# PALLAS_NOTE: every format is held against the reference's XLA path; the
# Pallas kernels (seconds of interpret-mode compile per format) are run on
# int4, whose unpacking is the harder half. tests/test_ragged_attention.py
# holds the Pallas kernels to that XLA path on int8 pools.


@pytest.mark.parametrize("mode", MODES)
def test_decode_plain_over_quantized_pool_matches_reference_and_pallas(mode):
    # the shapes of the reference's own quantized decode test
    rng = np.random.RandomState(41)
    pages, B = 12, 3
    jk, tk = _both(*_random_quant_layer(rng, mode, pages))
    jv, tv = _both(*_random_quant_layer(rng, mode, pages))
    tables = np.stack([rng.choice(pages, 4, replace=False) for _ in range(B)]).astype(np.int32)
    seq_lens = np.asarray([13, 5, 20], np.int32)
    q = rng.randn(B, H, D).astype(np.float32)
    got = tops.paged_attention_decode(_t(q)[0], tk, tv, *_t(tables, seq_lens)).numpy()
    want = np.asarray(jops.paged_attention_decode(jnp.asarray(q), jk, jv, *_j(tables, seq_lens)))
    np.testing.assert_allclose(got, want, **TOL)
    if mode == "int4":  # see PALLAS_NOTE
        pallas = np.asarray(paged_attention_decode_pallas(
            jnp.asarray(q), jk, jv, *_j(tables, seq_lens), interpret=True))
        np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_plain_over_quantized_pool_matches_reference(mode):
    rng = np.random.RandomState(7)
    B, T, P = 2, 16, 6
    pages = B * P + 2
    jk, tk = _both(*_random_quant_layer(rng, mode, pages))
    jv, tv = _both(*_random_quant_layer(rng, mode, pages))
    tables = rng.permutation(pages)[: B * P].reshape(B, P).astype(np.int32)
    starts = np.asarray([0, 21], np.int32)
    reals = np.asarray([16, 9])
    totals = (starts + reals).astype(np.int32)
    positions = (starts[:, None] + np.arange(T)[None, :]).astype(np.int32)
    q = rng.randn(B, T, H, D).astype(np.float32)
    got = tops.prefill_attention_batched(
        _t(q)[0], tk, tv, *_t(positions, tables, totals, starts)).numpy()
    want = np.asarray(jops.prefill_attention_batched(
        jnp.asarray(q), jk, jv, *_j(positions, tables, totals, starts)))
    for b, real in enumerate(reals):
        np.testing.assert_allclose(got[b, :real], want[b, :real], **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_ragged_plain_over_quantized_pool_matches_reference_and_pallas(mode):
    rows = [(24, 7), (1, 13), (1, 40), (9, 0), (1, 1), (17, 31)]
    rng = np.random.RandomState(6)
    N, R, P = 128, 8, 7
    align = jax_ragged_tile_q(jnp.float32)  # the TPU kernel needs aligned rows
    pages = R * P + 4
    jk, tk = _both(*_random_quant_layer(rng, mode, pages))
    jv, tv = _both(*_random_quant_layer(rng, mode, pages))
    q = rng.randn(N, H, D).astype(np.float32)
    tables = rng.permutation(pages)[: R * P].reshape(R, P).astype(np.int32)
    row_starts = np.full((R,), N, np.int32)
    row_lens = np.zeros((R,), np.int32)
    ctx_lens = np.zeros((R,), np.int32)
    off = 0
    for r, (ln, ctx) in enumerate(rows):
        row_starts[r], row_lens[r], ctx_lens[r] = off, ln, ctx
        off += -(-ln // align) * align
    idx = (tables, row_starts, row_lens, ctx_lens)
    got = tops.ragged_attention(_t(q)[0], tk, tv, *_t(*idx)).numpy()
    want = np.asarray(jops.ragged_attention_reference(jnp.asarray(q), jk, jv, *_j(*idx)))
    pallas = None
    if mode == "int4":  # see PALLAS_NOTE
        pallas = np.asarray(ragged_paged_attention_pallas(
            jnp.asarray(q), jk, jv, *_j(*idx), interpret=True))
    assert np.isfinite(got).all()
    for start, ln in zip(row_starts, row_lens):
        if ln:
            np.testing.assert_allclose(got[start:start + ln], want[start:start + ln], **TOL)
            if pallas is not None:
                np.testing.assert_allclose(got[start:start + ln], pallas[start:start + ln], **TOL)
