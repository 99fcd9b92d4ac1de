"""The port's Llama forwards against the JAX reference, on the CPU.

Tiny f32 model (2 layers, hidden 64, D=16, page size 8); the same numpy
weights and inputs go through `dynamo_tpu.models.llama` and
`dynamo_tpu_torch.models.llama`. Tolerance 2e-3 on logits and written
pages: f32 summation order differs between XLA and PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-3, atol=2e-3)
PS, PAGES = 8, 24
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def weights():
    """(jax params, numpy tree, torch params) of one random init."""
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jparams)
    tree["lm_head"] = None if jparams["lm_head"] is None else np.asarray(jparams["lm_head"])
    return jparams, tree, params_from_jax(tree, device="cpu")


def _pools():
    shape = (JCFG.num_layers, PAGES, PS, JCFG.num_kv_heads, JCFG.head_dim)
    rng = np.random.RandomState(0)
    k = (rng.randn(*shape) * 0.1).astype(np.float32)  # stale page contents
    v = (rng.randn(*shape) * 0.1).astype(np.float32)
    return k, v


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_all_config_presets_agree():
    for name in ("llama3_8b", "llama3_70b", "llama3_2_3b", "tiny"):
        j, t = getattr(jl.LlamaConfig, name)(), getattr(tl.LlamaConfig, name)()
        for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
                  "num_heads", "num_kv_heads", "head_dim", "rope_theta",
                  "rms_norm_eps", "max_position", "tie_embeddings"):
            assert getattr(j, f) == getattr(t, f), (name, f)
    assert tl.LlamaConfig.llama3_2_3b().dtype == torch.bfloat16


def test_params_from_jax_round_trip(weights):
    jparams, tree, tparams = weights
    assert set(tparams) == {"embed", "layers", "final_norm", "lm_head"}
    np.testing.assert_array_equal(tparams["embed"].numpy(), tree["embed"])
    for name, leaf in tree["layers"].items():
        assert tparams["layers"][name].shape == leaf.shape  # stacked [L, in, out]
        np.testing.assert_array_equal(tparams["layers"][name].numpy(), leaf)
    np.testing.assert_array_equal(tparams["lm_head"].numpy(), tree["lm_head"])
    tied = dict(tree, lm_head=None)
    assert params_from_jax(tied, device="cpu")["lm_head"] is None
    half = params_from_jax(tree, dtype=torch.bfloat16, device="cpu")
    assert half["layers"]["wq"].dtype == torch.bfloat16
    assert tl.param_count(tparams) == jl.param_count(jparams)


def test_init_params_shapes_and_seed(weights):
    gen = torch.Generator().manual_seed(5)
    a = tl.init_params(TCFG, gen, device="cpu")
    b = tl.init_params(TCFG, torch.Generator().manual_seed(5), device="cpu")
    ref = weights[0]  # the reference's own init_params tree
    for name, leaf in ref["layers"].items():
        assert tuple(a["layers"][name].shape) == leaf.shape, name
        torch.testing.assert_close(a["layers"][name], b["layers"][name], rtol=0, atol=0)
    assert tuple(a["embed"].shape) == ref["embed"].shape
    tied = tl.init_params(tl.LlamaConfig.tiny(dtype=torch.float32, tie_embeddings=True),
                          gen, device="cpu")
    assert tied["lm_head"] is None


def test_rms_norm_and_rope_match():
    rng = np.random.RandomState(1)
    x = rng.randn(5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(
        tl.rms_norm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), rtol=1e-5, atol=1e-6)
    pos = np.asarray([[0, 1, 7, 300], [5, 64, 65, 511]], np.int32)
    jc, js_ = jl.rope_cos_sin(jnp.asarray(pos), 16, 500000.0)
    tc, tsn = tl.rope_cos_sin(_t(pos), 16, 500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tsn.numpy(), np.asarray(js_), rtol=1e-4, atol=1e-5)
    q = rng.randn(2, 4, 3, 16).astype(np.float32)
    np.testing.assert_allclose(
        tl.apply_rope(_t(q), tc, tsn).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(q), jc, js_)), rtol=1e-4, atol=1e-5)
    # bf16 input: rotation in f32, result cast back
    assert tl.apply_rope(_t(q).bfloat16(), tc, tsn).dtype == torch.bfloat16


def _prefill_inputs():
    rng = np.random.RandomState(2)
    B, T, P = 3, 16, 5
    tables = np.zeros((B, P), np.int32)
    tables[:, :4] = 1 + np.arange(B * 4).reshape(B, 4)
    ctx = np.asarray([0, 8, 3], np.int32)  # history of 0 / one page / mid-page
    last = np.asarray([15, 9, 0], np.int32)  # full / padded / one real token
    pad_pos = P * PS - 1
    pos = np.full((B, T), pad_pos, np.int32)
    for b in range(B):
        pos[b, : last[b] + 1] = ctx[b] + np.arange(last[b] + 1)
    toks = rng.randint(3, 500, size=(B, T)).astype(np.int32)
    return toks, pos, tables, ctx, last


def _real_mask_pages(k):
    return k[:, 1:]  # page 0 is scratch: every pad writes the same slot


def test_prefill_forward_batched_matches(weights):
    jparams, _, tparams = weights
    toks, pos, tables, ctx, last = _prefill_inputs()
    k0, v0 = _pools()
    jlog, jk, jv = jl.prefill_forward_batched(
        jparams, JCFG, *[jnp.asarray(a) for a in (toks, pos, k0, v0, tables, ctx, last)])
    tk, tv = _t(k0.copy()), _t(v0.copy())
    tlog, rk, rv = tl.prefill_forward_batched(
        tparams, TCFG, _t(toks), _t(pos), tk, tv, _t(tables), _t(ctx), _t(last))
    assert rk is tk and rv is tv  # written in place
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(_real_mask_pages(tk.numpy()), _real_mask_pages(np.asarray(jk)), **TOL)
    np.testing.assert_allclose(_real_mask_pages(tv.numpy()), _real_mask_pages(np.asarray(jv)), **TOL)


def test_decode_forward_matches_and_routes_overshoot_to_scratch(weights):
    jparams, _, tparams = weights
    rng = np.random.RandomState(4)
    B, P = 4, 3
    tables = np.zeros((B, P), np.int32)
    tables[:3] = 1 + np.arange(9).reshape(3, 3)
    # lane 2 sits PAST its table (position 24 >= 3 pages * 8): scratch write;
    # lane 3 is an inactive lane on a scratch table row
    positions = np.asarray([5, 16, 24, 0], np.int32)
    seq_lens = np.asarray([6, 17, 25, 0], np.int32)
    toks = rng.randint(3, 500, size=(B,)).astype(np.int32)
    k0, v0 = _pools()
    jlog, jk, jv = jl.decode_forward(
        jparams, JCFG, *[jnp.asarray(a) for a in (toks, positions, k0, v0, tables, seq_lens)])
    tk, tv = _t(k0.copy()), _t(v0.copy())
    tlog, _, _ = tl.decode_forward(
        tparams, TCFG, _t(toks), _t(positions), tk, tv, _t(tables), _t(seq_lens))
    np.testing.assert_allclose(tlog.numpy()[:2], np.asarray(jlog)[:2], **TOL)
    np.testing.assert_allclose(_real_mask_pages(tk.numpy()), _real_mask_pages(np.asarray(jk)), **TOL)
    # the overshooting lane and the idle lane touched nothing but page 0
    np.testing.assert_array_equal(tk.numpy()[:, 7:], k0[:, 7:])
    assert not np.array_equal(tk.numpy()[:, 0], k0[:, 0])


def _ragged_inputs(toks_a, toks_b):
    """Row 0: 12-token chunk after 8 cached tokens; row 1: decode at ctx 20;
    row 2: fresh 5-token chunk; dense packing, padded to N=32 / R=4."""
    N, R, P = 32, 4, 5
    pad_pos = P * PS - 1
    tables = np.zeros((R, P), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :4] = [5, 6, 7, 8]
    tables[2, :4] = [9, 10, 11, 12]
    row_starts = np.asarray([0, 12, 13, N], np.int32)
    row_lens = np.asarray([12, 1, 5, 0], np.int32)
    ctx_lens = np.asarray([8, 20, 0, 0], np.int32)
    last_flat = np.asarray([11, 12, 17, 0], np.int32)
    positions = np.full((N,), pad_pos, np.int32)
    positions[0:12] = 8 + np.arange(12)
    positions[12] = 20
    positions[13:18] = np.arange(5)
    row_ids = np.full((N,), R - 1, np.int32)
    row_ids[0:12], row_ids[12], row_ids[13:18] = 0, 1, 2
    toks = np.zeros((N,), np.int32)
    toks[0:12], toks[12], toks[13:18] = toks_a[:12], toks_b, toks_a[12:17]
    return toks, positions, row_ids, tables, row_starts, row_lens, ctx_lens, last_flat


def test_ragged_forward_matches(weights):
    jparams, _, tparams = weights
    rng = np.random.RandomState(6)
    args = _ragged_inputs(rng.randint(3, 500, size=20).astype(np.int32), 77)
    toks, positions, row_ids, *rest = args
    k0, v0 = _pools()
    jlog, jk, jv = jl.ragged_forward(
        jparams, JCFG, *[jnp.asarray(a) for a in (toks, positions, row_ids, k0, v0, *rest)])
    tk, tv = _t(k0.copy()), _t(v0.copy())
    tlog, _, _ = tl.ragged_forward(
        tparams, TCFG, _t(toks), _t(positions), _t(row_ids), tk, tv, *[_t(a) for a in rest])
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    np.testing.assert_allclose(_real_mask_pages(tk.numpy()), _real_mask_pages(np.asarray(jk)), **TOL)
    np.testing.assert_allclose(_real_mask_pages(tv.numpy()), _real_mask_pages(np.asarray(jv)), **TOL)


def test_ragged_pack_equals_split_prefill_and_decode(weights):
    """Inside the port: one ragged step gives the same logits and pages as
    the batched-prefill call plus the decode call it fuses."""
    _, _, tparams = weights
    rng = np.random.RandomState(8)
    chunk = rng.randint(3, 500, size=20).astype(np.int32)
    toks, positions, row_ids, tables, row_starts, row_lens, ctx_lens, last_flat = \
        _ragged_inputs(chunk, 77)
    k0, v0 = _pools()
    rk, rv = _t(k0.copy()), _t(v0.copy())
    rlog, _, _ = tl.ragged_forward(
        tparams, TCFG, _t(toks), _t(positions), _t(row_ids), rk, rv, _t(tables),
        _t(row_starts), _t(row_lens), _t(ctx_lens), _t(last_flat))
    sk, sv = _t(k0.copy()), _t(v0.copy())
    T = 16
    pad_pos = tables.shape[1] * PS - 1
    p_toks = np.zeros((2, T), np.int32)
    p_pos = np.full((2, T), pad_pos, np.int32)
    p_toks[0, :12], p_pos[0, :12] = chunk[:12], 8 + np.arange(12)
    p_toks[1, :5], p_pos[1, :5] = chunk[12:17], np.arange(5)
    plog, _, _ = tl.prefill_forward_batched(
        tparams, TCFG, _t(p_toks), _t(p_pos), sk, sv, _t(tables[[0, 2]]),
        _t(np.asarray([8, 0], np.int32)), _t(np.asarray([11, 4], np.int32)))
    dlog, _, _ = tl.decode_forward(
        tparams, TCFG, _t(np.asarray([77], np.int32)), _t(np.asarray([20], np.int32)),
        sk, sv, _t(tables[[1]]), _t(np.asarray([21], np.int32)))
    np.testing.assert_allclose(rlog.numpy()[[0, 2]], plog.numpy(), **TOL)
    np.testing.assert_allclose(rlog.numpy()[[1]], dlog.numpy(), **TOL)
    np.testing.assert_allclose(_real_mask_pages(rk.numpy()), _real_mask_pages(sk.numpy()), **TOL)
    np.testing.assert_allclose(_real_mask_pages(rv.numpy()), _real_mask_pages(sv.numpy()), **TOL)


def test_plain_attention_argument_is_equivalent_on_cpu(weights):
    _, _, tparams = weights
    toks, pos, tables, ctx, last = _prefill_inputs()
    k0, v0 = _pools()
    a, _, _ = tl.prefill_forward_batched(
        tparams, TCFG, _t(toks), _t(pos), _t(k0.copy()), _t(v0.copy()), _t(tables),
        _t(ctx), _t(last))
    b, _, _ = tl.prefill_forward_batched(
        tparams, TCFG, _t(toks), _t(pos), _t(k0.copy()), _t(v0.copy()), _t(tables),
        _t(ctx), _t(last), plain_attention=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
