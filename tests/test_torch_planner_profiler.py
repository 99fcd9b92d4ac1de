"""The planner profiler's forwards and profiles, port against reference.

Single-sequence `prefill_attention` and `prefill_forward` of the port
against the JAX ones on the CPU (the reference's XLA path there): tiny f32
model, weights carried over by `models/convert.py:params_from_jax`, logits
and written KV pages within 2e-3, for a chunk after history and for a
padded chunk with `last_idx`. Then `planner.profiler.main` on `tiny` with
small grids on the CPU: its npz files have the reference's keys, dtypes
and grid with finite positive times, the JAX package's interpolators load
them, and the port's interpolators load the JAX profiler's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu.planner import perf_interpolation as jpi
from dynamo_tpu.planner import profiler as jprof
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.ops import paged_attention as tpa
from dynamo_tpu_torch.planner import perf_interpolation as tpi
from dynamo_tpu_torch.planner import profiler as tprof

TOL = dict(rtol=2e-3, atol=2e-3)
PS, PAGES = 8, 24
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
PREFILL_KEYS = {"prefill_isl", "prefill_ttft", "prefill_thpt_per_gpu"}
DECODE_KEYS = {"x_kv_usage", "y_context_length", "z_itl", "z_thpt_per_gpu", "max_kv_tokens"}


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, jparams)
    tree["lm_head"] = None if jparams["lm_head"] is None else np.asarray(jparams["lm_head"])
    return jparams, params_from_jax(tree, device="cpu")


def _pools(seed):
    shape = (JCFG.num_layers, PAGES, PS, JCFG.num_kv_heads, JCFG.head_dim)
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.1).astype(np.float32) for _ in range(2)]


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("T,ctx", [(12, 0), (9, 13), (16, 30)])
def test_prefill_attention_matches_reference(T, ctx):
    """The chunk's rows at ctx .. ctx+T-1 over pages holding history and
    the chunk; the table's pages out of order."""
    rng = np.random.default_rng(T + ctx)
    H, KH, D = 4, 2, 16
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k = rng.standard_normal((PAGES, PS, KH, D)).astype(np.float32)
    v = rng.standard_normal((PAGES, PS, KH, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, PAGES))[:8].astype(np.int32)
    pos = np.arange(ctx, ctx + T, dtype=np.int32)
    ref = jpa.prefill_attention(jnp.asarray(q), None, None, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos), jnp.asarray(table),
                                jnp.asarray(ctx, jnp.int32), jnp.asarray(ctx + T, jnp.int32))
    calls = tpa.plain_calls["prefill"]
    out = tpa.prefill_attention(_t(q), _t(k), _t(v), _t(pos), _t(table), ctx, ctx + T)
    assert tpa.plain_calls["prefill"] == calls + 1  # a CPU tensor: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _forward_both(weights, seed, chunks):
    """Run `chunks` [(tokens, start, last_idx or None)] of one sequence in
    order through both forwards on the same stale pools; returns the
    logits of each chunk and the final pools, reference then port."""
    jparams, tparams = weights
    k0, v0 = _pools(seed)
    table = np.random.default_rng(seed).permutation(np.arange(1, PAGES))[:10].astype(np.int32)
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    tk, tv = _t(k0.copy()), _t(v0.copy())
    jl_out, tl_out = [], []
    for toks, start, last in chunks:
        pos = np.arange(start, start + len(toks), dtype=np.int32)
        li = None if last is None else jnp.asarray(last, jnp.int32)
        lg, jk, jv = jl.prefill_forward(
            jparams, JCFG, jnp.asarray(toks, jnp.int32), jnp.asarray(pos), jk, jv,
            jnp.asarray(table), jnp.asarray(start, jnp.int32), li)
        jl_out.append(np.asarray(lg))
        with torch.inference_mode():
            tlg, tk, tv = tl.prefill_forward(
                tparams, TCFG, _t(np.asarray(toks, np.int64)), _t(pos), tk, tv,
                _t(table), start, last)
        tl_out.append(tlg.numpy())
    return jl_out, (np.asarray(jk), np.asarray(jv)), tl_out, (tk.numpy(), tv.numpy())


def test_prefill_forward_chunk_after_history(weights):
    rng = np.random.default_rng(1)
    first = rng.integers(3, 500, size=20)
    second = rng.integers(3, 500, size=11)
    jlog, jkv, tlog, tkv = _forward_both(weights, 1, [(first, 0, None), (second, 20, None)])
    for a, b in zip(tlog, jlog):
        assert a.shape == (JCFG.vocab_size,)
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(a, b, **TOL)


def test_prefill_forward_padded_chunk_last_idx(weights):
    """A 16-token bucket holding 9 real tokens after 5 of history: the
    logits are the 9th token's, the pads' KV lands at their positions."""
    rng = np.random.default_rng(2)
    hist = rng.integers(3, 500, size=5)
    chunk = np.concatenate([rng.integers(3, 500, size=9), np.zeros(7, np.int64)])
    jlog, jkv, tlog, tkv = _forward_both(weights, 2, [(hist, 0, None), (chunk, 5, 8)])
    np.testing.assert_allclose(tlog[1], jlog[1], **TOL)
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(a, b, **TOL)
    # without last_idx the logits are the last pad's: another row
    _, _, tlast, _ = _forward_both(weights, 2, [(hist, 0, None), (chunk, 5, None)])
    assert not np.allclose(tlast[1], tlog[1], **TOL)


ISL, CTX, USAGE, MAX_KV = [32, 64, 128], [64, 128], [0.2, 0.6], 2048


@pytest.fixture(scope="module")
def port_profile(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_profile")
    raw = tprof.main(["--model", "tiny", "--output-dir", str(out), "--device", "cpu",
                      "--isl-grid", *map(str, ISL), "--context-grid", *map(str, CTX),
                      "--kv-usage-grid", *map(str, USAGE), "--max-kv-tokens", str(MAX_KV)])
    return out, raw


def _load(d, sub):
    with np.load(os.path.join(d, sub, "raw_data.npz")) as f:
        return {k: f[k] for k in f.files}


def test_profiler_main_writes_reference_layout(port_profile):
    out, raw = port_profile
    p = _load(out, "selected_prefill_interpolation")
    d = _load(out, "selected_decode_interpolation")
    assert set(p) == PREFILL_KEYS and set(d) == DECODE_KEYS
    assert all(a.dtype == np.float64 for a in (*p.values(), *d.values()))
    np.testing.assert_array_equal(p["prefill_isl"], ISL)
    # the reference's grid: usage-major within each context, every point kept
    np.testing.assert_array_equal(d["x_kv_usage"], USAGE * len(CTX))
    np.testing.assert_array_equal(d["y_context_length"], np.repeat(CTX, len(USAGE)))
    np.testing.assert_array_equal(d["max_kv_tokens"], [MAX_KV])
    for a in (p["prefill_ttft"], p["prefill_thpt_per_gpu"], d["z_itl"], d["z_thpt_per_gpu"]):
        assert np.all(np.isfinite(a)) and np.all(a > 0)
    # throughput is the batch over the step time
    lanes = [tprof.decode_batch(u, c, MAX_KV, 64) for c in CTX for u in USAGE]
    np.testing.assert_allclose(d["z_thpt_per_gpu"], np.asarray(lanes) / (d["z_itl"] / 1e3))
    np.testing.assert_allclose(p["prefill_thpt_per_gpu"],
                               p["prefill_isl"] / (p["prefill_ttft"] / 1e3))
    for k in PREFILL_KEYS:
        np.testing.assert_array_equal(raw["prefill"][k], p[k])


def test_decode_batch_matches_reference_sizing():
    """The lanes of each point as the reference's sweep sizes them (the
    batch clipped to the pool, a point dropped when no lane fits)."""
    for ctx in (256, 1024, 4096, 70000):
        for usage in (0.1, 0.25, 0.5, 0.75, 0.95):
            num_pages = (1 << 16) // 64 + 1
            pps = (ctx + 63) // 64
            B = max(1, int(usage * (1 << 16) / ctx))
            if B * pps >= num_pages:
                B = (num_pages - 1) // pps
            assert tprof.decode_batch(usage, ctx, 1 << 16, 64) == max(B, 0)
    assert tprof.decode_batch(0.95, 256, 1 << 16, 64) == 243  # the sweep's widest point
    assert tprof.decode_batch(0.95, 4096, 1 << 16, 64) == 15


def test_port_profile_loads_in_reference_interpolators(port_profile):
    out, _ = port_profile
    pi = jpi.PrefillInterpolator(profile_results_dir=str(out))
    di = jpi.DecodeInterpolator(profile_results_dir=str(out))
    assert pi.interpolate_ttft(64) > 0 and pi.interpolate_thpt_per_chip(64) > 0
    thpt, itl, _ = di.find_best_throughput_per_chip(itl=10.0, context_length=128)
    assert thpt > 0 and itl > 0
    # and the port's interpolators read the same file to the same values
    tpi_p = tpi.PrefillInterpolator(profile_results_dir=str(out))
    tpi_d = tpi.DecodeInterpolator(profile_results_dir=str(out))
    for isl in (16, 40, 64, 100, 128, 500):
        assert tpi_p.interpolate_ttft(isl) == pi.interpolate_ttft(isl)
    np.testing.assert_array_equal(tpi_d.itl_grid, di.itl_grid)
    np.testing.assert_array_equal(tpi_d.thpt_grid, di.thpt_grid)


def test_reference_profile_loads_in_port_interpolators(tmp_path):
    cfg = jl.LlamaConfig.tiny()
    p_raw = jprof.profile_prefill(cfg, [32, 64], page=16)
    d_raw = jprof.profile_decode(cfg, [64, 128], [0.2, 0.6], max_kv_tokens=1024, page=16,
                                 decode_steps=1)
    jprof.write_profiles(str(tmp_path), p_raw, d_raw)
    pi = tpi.PrefillInterpolator(profile_results_dir=str(tmp_path))
    di = tpi.DecodeInterpolator(profile_results_dir=str(tmp_path))
    ref_p = jpi.PrefillInterpolator(profile_results_dir=str(tmp_path))
    ref_d = jpi.DecodeInterpolator(profile_results_dir=str(tmp_path))
    for isl in (32, 48, 64):
        assert pi.interpolate_ttft(isl) == ref_p.interpolate_ttft(isl) > 0
        assert pi.interpolate_thpt_per_chip(isl) == ref_p.interpolate_thpt_per_chip(isl) > 0
    assert di.find_best_throughput_per_chip(itl=10.0, context_length=64) == \
        ref_d.find_best_throughput_per_chip(itl=10.0, context_length=64)
    np.testing.assert_array_equal(di.itl_grid, ref_d.itl_grid)
