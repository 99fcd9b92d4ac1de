"""The port's local decode block (pool read-only for K steps, block-local
KV merged in the attention) against the JAX reference, on the CPU.

Three levels, the same numpy inputs on both sides:
  * `paged_attention_decode_mixed` (plain version) against the reference's
    XLA path over fp, int8 and int4 pools, and its Pallas kernel
    `_decode_local_kernel` run with `interpret=True` over an int4 pool
    (QuantKV operands: the unpack, the scales and the local merge at
    once), at 2e-3 in f32;
  * `decode_forward_local` against the reference's, logits and the
    block-local buffers, over fp and int8 pools, at 2e-3 in f32;
  * `TorchEngine` against `JaxEngine` on the 6-request trace of
    tests/test_torch_engine.py: token-identical streams (greedy and seeded)
    for (local, none), (scatter, int8) and (local, int4).

The reference engine is run with `decode_block_unroll=1`: its "local" mode
otherwise unrolls the block's scan, which changes its compile time and not
its arithmetic.
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
from dynamo_tpu.ops import kv_quant as jkv
from dynamo_tpu.ops import paged_attention as jops
from dynamo_tpu.ops.pallas_paged_attention import paged_attention_decode_pallas_local
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.ops import kv_quant as tkv
from dynamo_tpu_torch.ops import paged_attention as tops
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import ENGINE_KW, drive, numpy_params

TOL = dict(rtol=2e-3, atol=2e-3)
H, KH, D, PS = 4, 2, 32, 8
FORMATS = ["none", "int8", "int4"]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pool_layer(rng, fmt, pages, dim=D, layers=None):
    """One pool (K or V) in `fmt` for both packages: random fp values, or
    random bytes with positive scales (some pages fresh, scale 0). With
    `layers`, a whole [L, ...] store; else one layer."""
    lead = () if layers is None else (layers,)
    if fmt == "none":
        x = (rng.randn(*lead, pages, PS, KH, dim) * 0.5).astype(np.float32)
        return jnp.asarray(x), torch.from_numpy(x.copy())
    bits = tkv.kv_quant_bits(fmt)
    rows = PS // 2 if bits == 4 else PS
    q = rng.randint(-127, 128, size=(*lead, pages, rows, KH, dim)).astype(np.int8)
    s = (rng.rand(*lead, pages, KH) * 0.02).astype(np.float32)
    s[..., ::5, :] = 0.0
    return (jkv.QuantKV(jnp.asarray(q), jnp.asarray(s), bits, PS),
            tkv.QuantKV(*_t(q, s), bits, PS))


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_mixed_plain_matches_reference_and_pallas(fmt):
    # the shapes of the reference's quantized decode test, plus an empty lane
    rng = np.random.RandomState(41)
    pages, B, K, step = 12, 4, 4, 2
    jk, tk = _pool_layer(rng, fmt, pages)
    jv, tv = _pool_layer(rng, fmt, pages)
    tables = np.stack([rng.choice(pages, 4, replace=False) for _ in range(B)]).astype(np.int32)
    pool_lens = np.asarray([12, 4, 19, 0], np.int32)
    q = rng.randn(B, H, D).astype(np.float32)
    loc_k = rng.randn(B, K, KH, D).astype(np.float32)
    loc_v = rng.randn(B, K, KH, D).astype(np.float32)
    step_idx = np.asarray([step], np.int32)
    got = tops.paged_attention_decode_mixed(
        _t(q)[0], tk, tv, *_t(tables, pool_lens, loc_k, loc_v, step_idx)).numpy()
    jargs = [jnp.asarray(a) for a in (tables, pool_lens, loc_k, loc_v)]
    want = np.asarray(jops.paged_attention_decode_mixed(
        jnp.asarray(q), jk, jv, *jargs, jnp.asarray(step)))
    np.testing.assert_allclose(got, want, **TOL)
    if fmt == "int4":  # see tests/test_torch_kv_quant.py PALLAS_NOTE
        pallas = np.asarray(paged_attention_decode_pallas_local(
            jnp.asarray(q), jk, jv, *jargs, jnp.asarray(step), interpret=True))
        # the TPU kernel clamps an empty pool to length 1 (it attends pool
        # key 0) while the reference's plain path, which the port follows,
        # masks every pool key: only inactive lanes have an empty pool, and
        # their output is discarded. So the last lane is held against the
        # plain path alone.
        np.testing.assert_allclose(got[:3], pallas[:3], **TOL)
    # entries past step_idx are not read: changing them changes nothing
    loc_k[:, step + 1:] = 99.0
    again = tops.paged_attention_decode_mixed(
        _t(q)[0], tk, tv, *_t(tables, pool_lens, loc_k, loc_v, step_idx)).numpy()
    np.testing.assert_array_equal(again, got)


JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def trace_weights():
    return numpy_params()


@pytest.fixture(scope="module")
def weights(trace_weights):
    """(jax params, torch params) of one numpy init."""
    jparams = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), trace_weights,
                           is_leaf=lambda a: a is None)
    return jparams, params_from_jax(trace_weights, device="cpu")


@pytest.mark.parametrize("fmt", ["none", "int8"])
def test_decode_forward_local_matches_jax(weights, fmt):
    jparams, tparams = weights
    rng = np.random.RandomState(8)
    L, B, K, step, pages, P = JCFG.num_layers, 4, 4, 1, 24, 3
    dim = JCFG.head_dim
    jk, tk = _pool_layer(rng, fmt, pages, dim=dim, layers=L)
    jv, tv = _pool_layer(rng, fmt, pages, dim=dim, layers=L)
    tables = np.zeros((B, P), np.int32)
    tables[:3] = 1 + np.arange(9).reshape(3, 3)  # lane 3: inactive, scratch row
    pool_lens = np.asarray([5, 16, 9, 0], np.int32)
    positions = pool_lens + step
    toks = rng.randint(3, 500, size=(B,)).astype(np.int32)
    loc = (rng.randn(2, L, B, K, KH, dim) * 0.5).astype(np.float32)
    fwd = jax.jit(jl.decode_forward_local, static_argnums=1)
    jlog, jlk, jlv = fwd(
        jparams, JCFG, jnp.asarray(toks), jnp.asarray(positions),
        tuple(jnp.asarray(loc[0, li]) for li in range(L)),
        tuple(jnp.asarray(loc[1, li]) for li in range(L)),
        jnp.asarray(step), jk, jv, jnp.asarray(tables), jnp.asarray(pool_lens))
    tloc = torch.from_numpy(loc.copy())
    tlog, tlk, tlv = tl.decode_forward_local(
        tparams, TCFG, *_t(toks, positions), tloc[0], tloc[1],
        torch.tensor([step], dtype=torch.int32), tk, tv, *_t(tables, pool_lens))
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    for li in range(L):
        np.testing.assert_allclose(tlk[li].numpy(), np.asarray(jlk[li]), **TOL)
        np.testing.assert_allclose(tlv[li].numpy(), np.asarray(jlv[li]), **TOL)
    # only slot `step` of the local buffers was written, in place
    np.testing.assert_array_equal(tloc[0, :, :, step + 1:].numpy(), loc[0, :, :, step + 1:])
    assert not np.array_equal(tloc[0, :, :, step].numpy(), loc[0, :, :, step])


# ---------------------------------------------------------------------- #
# the engines, on the trace of tests/test_torch_engine.py
# ---------------------------------------------------------------------- #

ENGINE_CASES = [("local", "none"), ("scatter", "int8"), ("local", "int4")]


@pytest.fixture(scope="module", params=ENGINE_CASES, ids=lambda c: "-".join(c))
def reference(request, weights):
    """(case, streams and stats of the JAX engine) for one configuration."""
    mode, kvq = request.param
    params = weights[0]
    engine = JaxEngine(
        JaxEngineConfig(**ENGINE_KW, decode_pool_mode=mode, kv_quant=kvq,
                        decode_block_unroll=1),
        model_config=JCFG, params=params)
    return request.param, asyncio.run(drive(engine, JaxRequest, JaxContext))


def test_engine_streams_token_identical_to_jax_engine(trace_weights, reference):
    (mode, kvq), (want, ref_stats) = reference
    engine = TorchEngine(
        EngineConfig(**ENGINE_KW, decode_pool_mode=mode, kv_quant=kvq),
        model_config=TCFG, params=params_from_jax(trace_weights, device="cpu"),
        device="cpu",
    )
    assert engine.config.decode_pool_mode == mode and engine.config.kv_quant == kvq
    got, stats = asyncio.run(drive(engine, PreprocessedRequest, Context))
    assert set(got) == set(want)
    for rid in sorted(want):
        assert got[rid][0] == want[rid][0], f"{rid}: token streams differ"
        assert got[rid][1] == want[rid][1] == "length", rid
    # the trace really exercised the paths: seeded lanes, preemption,
    # prefix reuse, mixed steps and fused blocks
    assert stats["num_preemptions"] >= 1 and ref_stats["num_preemptions"] >= 1
    assert stats["kv_prefix_hit_blocks_total"] + stats["kv_skip_ahead_blocks"] > 0
    assert stats["mixed_steps"] >= 1 and stats["dev_time"]["block"]["count"] >= 1
    assert stats["kv_quant"] == ref_stats["kv_quant"] == kvq
    assert stats["kv_pool_bytes"] == ref_stats["kv_pool_bytes"]


def test_engine_resolves_kv_format_and_reports_pool_bytes(monkeypatch):
    monkeypatch.setenv("DYN_KV_QUANT", "int4")
    cfg = EngineConfig(**ENGINE_KW, decode_block_unroll=3)
    engine = TorchEngine(cfg, model_config=TCFG, device="cpu")
    stats = engine.stats()
    asyncio.run(engine.close())
    assert cfg.kv_quant is None and cfg.decode_pool_mode is None  # caller's copy kept
    assert engine.config.kv_quant == "int4" and engine.config.decode_pool_mode == "scatter"
    assert engine.config.decode_block_unroll == 3  # accepted, without effect
    pages = ENGINE_KW["num_pages"] + 1  # + the scratch page
    per_page = tkv.kv_page_bytes(ENGINE_KW["page_size"], TCFG.num_kv_heads,
                                 TCFG.head_dim, TCFG.dtype, "int4")
    assert stats["kv_pool_bytes"] == 2 * TCFG.num_layers * pages * per_page
    assert stats["kv_quant"] == "int4"
    bad = dataclasses.replace(cfg, decode_pool_mode="copy")
    with pytest.raises(ValueError, match="decode_pool_mode"):
        TorchEngine(bad, model_config=TCFG, device="cpu")
