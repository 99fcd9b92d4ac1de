"""The port's int8 weight-only quantization against the JAX reference, on the CPU.

The same numpy weights go through `dynamo_tpu.models.quant` and
`dynamo_tpu_torch.models.quant`: `quantize_array` must be bit-equal (ints
and scales) on numpy and torch input; `qdot`, `embed_rows` and the tied
`head_leaf` agree within 2e-3 in f32 and 5e-2 in bf16; `quantize_tree`
matches leaf for leaf, `consume` included; the four llama forwards over an
int8 tree agree within 2e-3 in f32 (logits and written pages); and
`TorchEngine(quantize="int8")` streams the same tokens as
`JaxEngine(quantize="int8")` on a tiny f32 model. Weights are drawn at
standard deviation 0.15 (tests/test_torch_engine.py says why).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.llm.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import quant as jq
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import quant as tq
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import ENGINE_KW, drive, numpy_params
from tests.test_torch_llama import _pools, _prefill_inputs, _ragged_inputs, _real_mask_pages

TOL = dict(rtol=2e-3, atol=2e-3)
TOL_BF16 = dict(rtol=5e-2, atol=5e-2)
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jnp_tree(tree):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def _np_tree(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


@pytest.mark.parametrize("contract_axis", [-2, -1])
def test_quantize_array_bit_equal_to_reference(contract_axis):
    rng = np.random.RandomState(0)
    w = (rng.randn(3, 48, 40) * 0.2).astype(np.float32)
    w[1, :, 5] = 0.0  # an all-zero channel: the eps floor of the scale
    w[2, 7] = 1e-9
    want_np = jq.quantize_array(w, contract_axis=contract_axis)
    want_jax = jq.quantize_array(jnp.asarray(w), contract_axis=contract_axis)
    got_np = tq.quantize_array(w, contract_axis=contract_axis)
    got_t = tq.quantize_array(torch.from_numpy(w), contract_axis=contract_axis)
    assert got_t["q"].dtype == torch.int8 and got_t["s"].dtype == torch.float32
    for want in (want_np, want_jax):
        for got in (got_np, {k: v.numpy() for k, v in got_t.items()}):
            np.testing.assert_array_equal(got["q"], np.asarray(want["q"]))
            np.testing.assert_array_equal(got["s"], np.asarray(want["s"]))
    # slice-by-slice quantization into preallocated leaves gives the same bits
    q = torch.empty(w.shape[1:], dtype=torch.int8)
    s_shape = list(w.shape[1:])
    s_shape[contract_axis] = 1
    s = torch.empty(s_shape)
    old, tq._CHUNK_ELEMS = tq._CHUNK_ELEMS, 100  # several slices
    try:
        tq.quantize_into(q, s, torch.from_numpy(w[0]), contract_axis)
    finally:
        tq._CHUNK_ELEMS = old
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_np["q"])[0])
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_np["s"])[0])
    np.testing.assert_array_equal(
        tq.dequantize_leaf(got_t, torch.float32).numpy(),
        np.asarray(jq.dequantize_leaf(want_jax, jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdot_embed_rows_and_tied_head_match_reference(dtype):
    rng = np.random.RandomState(1)
    V, H, O = 96, 64, 48
    emb = (rng.randn(V, H) * 0.3).astype(np.float32)
    w = (rng.randn(H, O) * 0.3).astype(np.float32)
    x = rng.randn(5, 3, H).astype(np.float32)
    toks = rng.randint(0, V, size=(5, 3)).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = TOL if dtype == "float32" else TOL_BF16
    jw = jq.quantize_array(w)
    jemb = jq.quantize_array(emb, contract_axis=-1)
    tw = {k: torch.from_numpy(np.asarray(v)) for k, v in jw.items()}
    temb = {k: torch.from_numpy(np.asarray(v)) for k, v in jemb.items()}
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    # the reference returns f32 and the model casts; the port's default
    # output is the operands' type
    want = np.asarray(jq.qdot(jx, {k: jnp.asarray(v) for k, v in jw.items()}))
    got = tq.qdot(tx, tw)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    np.testing.assert_allclose(tq.qdot(tx, tw, out_dtype=torch.float32).numpy(), want, **tol)
    rows = tq.embed_rows(temb, torch.from_numpy(toks), tdt)
    jrows = jq.embed_rows({k: jnp.asarray(v) for k, v in jemb.items()}, jnp.asarray(toks), jdt)
    assert rows.dtype == tdt and rows.shape == (5, 3, H)
    np.testing.assert_allclose(rows.float().numpy(), np.asarray(jrows.astype(jnp.float32)), **tol)
    # tied head: the per-row embedding scale [V, 1] is a per-out-channel [1, V]
    head = tq.head_leaf({"embed": temb, "lm_head": None})
    jhead = jq.head_leaf({"embed": {k: jnp.asarray(v) for k, v in jemb.items()}, "lm_head": None})
    assert tuple(head["q"].shape) == (H, V) and tuple(head["s"].shape) == (1, V)
    np.testing.assert_array_equal(head["s"].numpy(), np.asarray(jhead["s"]))
    logits = tq.qdot(tx[0], head, out_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jq.qdot(jx[0], jhead)), **tol)
    # the scale multiplies the f32 accumulator: equal to dequantize-then-dot
    deq = tq.dequantize_leaf(tw, torch.float32)
    np.testing.assert_allclose(tq.qdot(torch.from_numpy(x), tw).numpy(),
                               (torch.from_numpy(x) @ deq).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("consume", [False, True])
@pytest.mark.parametrize("source", ["numpy", "torch"])
def test_quantize_tree_matches_reference_leaf_for_leaf(consume, source):
    tree = numpy_params()
    want = _np_tree(jq.quantize_tree(_jnp_tree(numpy_params())))
    src = tree if source == "numpy" else params_from_jax(tree, device="cpu")
    got = tq.quantize_tree(src, consume=consume)
    leaves = [("embed", got["embed"], want["embed"]), ("lm_head", got["lm_head"], want["lm_head"])]
    leaves += [(k, got["layers"][k], want["layers"][k]) for k in want["layers"]]
    for name, g, w in leaves:
        assert tq.is_quant(g) == jq.is_quant(w), name
        if tq.is_quant(g):
            np.testing.assert_array_equal(np.asarray(g["q"]), w["q"], err_msg=name)
            np.testing.assert_array_equal(np.asarray(g["s"]), w["s"], err_msg=name)
            assert np.asarray(g["q"]).dtype == np.int8, name
        else:  # norms keep their values and dtype
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=name)
    assert got["embed"]["s"].shape == (JCFG.vocab_size, 1)
    # consume drops the source leaves as they are quantized
    dropped = src["embed"] is None and src["layers"]["wq"] is None and src["lm_head"] is None
    assert dropped == consume
    assert src["layers"]["attn_norm"] is not None
    if source == "torch":
        assert tq.param_bytes(got) < tq.param_bytes(params_from_jax(numpy_params(), device="cpu"))
        assert tl.param_count(got) == jl.param_count(jq.quantize_tree(_jnp_tree(numpy_params())))


@pytest.fixture(scope="module")
def qweights():
    """(jax int8 params, torch int8 params) of one numpy init, untied and tied."""
    out = {}
    for tied in (False, True):
        tree = numpy_params()
        if tied:
            tree["lm_head"] = None
        q = _np_tree(jq.quantize_tree(_jnp_tree(tree)))
        q["lm_head"] = None if tied else q["lm_head"]
        out[tied] = (_jnp_tree(q), params_from_jax(q, device="cpu"))
    return out


def _cfgs(tied):
    return (dataclasses.replace(JCFG, tie_embeddings=tied),
            dataclasses.replace(TCFG, tie_embeddings=tied))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_prefill_forward_batched_int8_matches(qweights, tied):
    jparams, tparams = qweights[tied]
    jc, tc = _cfgs(tied)
    assert tq.is_quant(tparams["layers"]["wq"]) and tparams["layers"]["wq"]["q"].dtype == torch.int8
    toks, pos, tables, ctx, last = _prefill_inputs()
    k0, v0 = _pools()
    jlog, jk, jv = jl.prefill_forward_batched(
        jparams, jc, *[jnp.asarray(a) for a in (toks, pos, k0, v0, tables, ctx, last)])
    tk, tv = _t(k0.copy(), v0.copy())
    tlog, _, _ = tl.prefill_forward_batched(tparams, tc, *_t(toks, pos), tk, tv,
                                            *_t(tables, ctx, last))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(_real_mask_pages(tk.numpy()), _real_mask_pages(np.asarray(jk)), **TOL)
    np.testing.assert_allclose(_real_mask_pages(tv.numpy()), _real_mask_pages(np.asarray(jv)), **TOL)


def test_decode_and_ragged_forwards_int8_match(qweights):
    jparams, tparams = qweights[True]
    jc, tc = _cfgs(True)
    rng = np.random.RandomState(4)
    B, P = 4, 3
    tables = np.zeros((B, P), np.int32)
    tables[:3] = 1 + np.arange(9).reshape(3, 3)
    positions = np.asarray([5, 16, 9, 0], np.int32)
    toks = rng.randint(3, 500, size=(B,)).astype(np.int32)
    k0, v0 = _pools()
    jlog, jk, _ = jl.decode_forward(
        jparams, jc, *[jnp.asarray(a) for a in (toks, positions, k0, v0, tables, positions + 1)])
    tk, tv = _t(k0.copy(), v0.copy())
    tlog, _, _ = tl.decode_forward(tparams, tc, *_t(toks, positions), tk, tv,
                                   *_t(tables, positions + 1))
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    np.testing.assert_allclose(_real_mask_pages(tk.numpy()), _real_mask_pages(np.asarray(jk)), **TOL)

    args = _ragged_inputs(rng.randint(3, 500, size=20).astype(np.int32), 77)
    rtoks, rpos, row_ids, *rest = args
    jlog, jk, _ = jl.ragged_forward(
        jparams, jc, *[jnp.asarray(a) for a in (rtoks, rpos, row_ids, k0, v0, *rest)])
    tk, tv = _t(k0.copy(), v0.copy())
    tlog, _, _ = tl.ragged_forward(tparams, tc, *_t(rtoks, rpos, row_ids), tk, tv, *_t(*rest))
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    np.testing.assert_allclose(_real_mask_pages(tk.numpy()), _real_mask_pages(np.asarray(jk)), **TOL)


def test_decode_forward_local_int8_matches(qweights):
    jparams, tparams = qweights[False]
    rng = np.random.RandomState(8)
    L, B, K, step, P = JCFG.num_layers, 4, 4, 1, 3
    KH, D = JCFG.num_kv_heads, JCFG.head_dim
    k0, v0 = _pools()
    tables = np.zeros((B, P), np.int32)
    tables[:3] = 1 + np.arange(9).reshape(3, 3)
    pool_lens = np.asarray([5, 16, 9, 0], np.int32)
    positions = pool_lens + step
    toks = rng.randint(3, 500, size=(B,)).astype(np.int32)
    loc = (rng.randn(2, L, B, K, KH, D) * 0.5).astype(np.float32)
    fwd = jax.jit(jl.decode_forward_local, static_argnums=1)
    jlog, jlk, _ = fwd(
        jparams, JCFG, jnp.asarray(toks), jnp.asarray(positions),
        tuple(jnp.asarray(loc[0, li]) for li in range(L)),
        tuple(jnp.asarray(loc[1, li]) for li in range(L)),
        jnp.asarray(step), jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(tables),
        jnp.asarray(pool_lens))
    tloc = torch.from_numpy(loc.copy())
    tlog, tlk, _ = tl.decode_forward_local(
        tparams, TCFG, *_t(toks, positions), tloc[0], tloc[1],
        torch.tensor([step], dtype=torch.int32), *_t(k0, v0, tables, pool_lens))
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    for li in range(L):
        np.testing.assert_allclose(tlk[li].numpy(), np.asarray(jlk[li]), **TOL)


@pytest.fixture(scope="module")
def int8_reference():
    """Streams of the JAX engine on the int8 tree of numpy_params()."""
    params = jq.quantize_tree(_jnp_tree(numpy_params()))
    engine = JaxEngine(JaxEngineConfig(**ENGINE_KW, quantize="int8"), model_config=JCFG,
                       params=params)
    return asyncio.run(drive(engine, JaxRequest, JaxContext))


def test_int8_engine_streams_token_identical_to_jax_engine(int8_reference):
    qtree = _np_tree(jq.quantize_tree(_jnp_tree(numpy_params())))
    engine = TorchEngine(EngineConfig(**ENGINE_KW, quantize="int8"), model_config=TCFG,
                         params=params_from_jax(qtree, device="cpu"), device="cpu")
    got, stats = asyncio.run(drive(engine, PreprocessedRequest, Context))
    want, ref_stats = int8_reference
    assert set(got) == set(want)
    for rid in sorted(want):
        assert got[rid][0] == want[rid][0], f"{rid}: token streams differ"
        assert got[rid][1] == want[rid][1] == "length", rid
    assert stats["num_preemptions"] >= 1 and stats["mixed_steps"] >= 1
    assert tq.is_quant(engine.params["layers"]["wq"])


def test_engine_quantizes_its_random_init():
    """quantize="int8" with no params: the seeded init, quantized in place
    of the full-precision tree, as an explicit quantize_tree of it."""
    cfg = EngineConfig(**ENGINE_KW, quantize="int8", seed=3)
    engine = TorchEngine(cfg, model_config=TCFG, device="cpu")
    gen = torch.Generator().manual_seed(3)
    want = tq.quantize_tree(tl.init_params(TCFG, gen, device="cpu"))
    for name in ("wq", "w_down"):
        torch.testing.assert_close(engine.params["layers"][name]["q"], want["layers"][name]["q"],
                                   rtol=0, atol=0)
    torch.testing.assert_close(engine.params["embed"]["s"], want["embed"]["s"], rtol=0, atol=0)
    full = TorchEngine(EngineConfig(**ENGINE_KW, seed=3), model_config=TCFG, device="cpu")
    st, st_full = engine.stats(), full.stats()
    assert st["weight_bytes"] == tq.param_bytes(want) < st_full["weight_bytes"]
    asyncio.run(engine.close())
    asyncio.run(full.close())


@pytest.mark.parametrize("mode", ["int4", "fp8"])
def test_unknown_quantize_mode_is_a_value_error(mode):
    with pytest.raises(ValueError, match="quantize"):
        TorchEngine(EngineConfig(**ENGINE_KW, quantize=mode), model_config=TCFG, device="cpu")
    assert EngineConfig(quantize="int8").unsupported_fields() == []


def test_auto_num_pages_counts_quantized_weights(monkeypatch):
    """DYN_HBM_BYTES sizing with an int8 tree counts its ints plus scales,
    as the reference's `_auto_num_pages` does."""
    from dynamo_tpu.engine.engine import _auto_num_pages as ref_auto

    from dynamo_tpu_torch.engine.engine import _auto_num_pages

    for k, v in {"DYN_HBM_BYTES": str(2**24), "DYN_HBM_UTILIZATION": "0.5",
                 "DYN_HBM_RESERVE_MB": "1", "DYN_WORKERS_PER_DEVICE": "1"}.items():
        monkeypatch.setenv(k, v)
    jtree = jq.quantize_tree(_jnp_tree(numpy_params()))
    want = ref_auto(jtree, JCFG, JaxEngineConfig(**{**ENGINE_KW, "num_pages": 0,
                                                    "decode_pool_mode": "local"}))
    ttree = params_from_jax(_np_tree(jtree), device="cpu")
    got = _auto_num_pages(ttree, TCFG, EngineConfig(**{**ENGINE_KW, "num_pages": 0}),
                          torch.device("cpu"))
    assert got == want
    full = _auto_num_pages(params_from_jax(numpy_params(), device="cpu"), TCFG,
                           EngineConfig(**{**ENGINE_KW, "num_pages": 0}), torch.device("cpu"))
    assert got > full  # int8 weights leave room for more pages
