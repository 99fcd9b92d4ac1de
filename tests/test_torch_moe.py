"""The port's sparse-MoE model against the JAX reference, on the CPU.

The same numpy weights and inputs go through `dynamo_tpu.models.moe` and
`dynamo_tpu_torch.models.moe` at `tiny_moe` widths (4 experts, top-2):

  * `moe_mlp` at capacity factor 1.25 on inputs whose routing is skewed so
    that tokens drop: the kept (token, expert, slot) sets are equal and the
    outputs agree within 2e-3 in f32 and 5e-2 in bf16, over bf16/f32 and
    int8 expert stacks; a router built so two experts' logits tie exactly
    at the top-k boundary picks the lower index on both sides;
  * `qeinsum` on expert stacks, and `quantize_tree` on the MoE tree (the
    expert stacks' ints and scales bit-equal; the f32 router untouched);
  * the four forwards (batched prefill, ragged, decode, local decode) in
    f32 over fp, int8 and int4 KV pools, logits and written pages within
    2e-3. Pads differ between the two packages by design (the ragged
    forward returns zeros outside every row, an empty local pool attends
    no key), and a pad takes expert capacity like any token, so the
    forwards run at capacity factor 8, where nothing drops.

The engine's MoE serving is held in tests/test_torch_moe_engine.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import moe as jm
from dynamo_tpu.models import quant as jq
from dynamo_tpu.ops import kv_quant as jkv
from dynamo_tpu_torch.models import moe as tm
from dynamo_tpu_torch.models import quant as tq
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.ops import kv_quant as tkv
from tests.test_torch_llama import _prefill_inputs, _ragged_inputs, _real_mask_pages

TOL = dict(rtol=2e-3, atol=2e-3)
TOL_BF16 = dict(rtol=5e-2, atol=5e-2)
WEIGHT_STD = 0.15  # the engine tests' weights (tests/test_torch_engine.py says why)
PS, PAGES = 8, 24
FORMATS = ["none", "int8", "int4"]
JCFG = jm.MoeConfig.tiny_moe(dtype=jnp.float32)
TCFG = tm.MoeConfig.tiny_moe(dtype=torch.float32)
# forwards and engines: nothing drops (see the module docstring)
JCFG8 = dataclasses.replace(JCFG, capacity_factor=8.0)
TCFG8 = dataclasses.replace(TCFG, capacity_factor=8.0)


def numpy_params(seed=0, std=WEIGHT_STD):
    """An MoE tree of the reference's layout with numpy leaves."""
    c = JCFG
    rng = np.random.RandomState(seed)
    q_dim, kv_dim = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
    L, Hd, I, E = c.num_layers, c.hidden_size, c.intermediate_size, c.num_experts

    def w(*shape):
        return (rng.randn(*shape) * std).astype(np.float32)

    return {
        "embed": w(c.vocab_size, Hd),
        "layers": {
            "attn_norm": np.ones((L, Hd), np.float32),
            "wq": w(L, Hd, q_dim), "wk": w(L, Hd, kv_dim), "wv": w(L, Hd, kv_dim),
            "wo": w(L, q_dim, Hd),
            "mlp_norm": np.ones((L, Hd), np.float32),
            "router": w(L, Hd, E),
            "w_gate": w(L, E, Hd, I), "w_up": w(L, E, Hd, I), "w_down": w(L, E, I, Hd),
        },
        "final_norm": np.ones((Hd,), np.float32),
        "lm_head": w(Hd, c.vocab_size),
    }


def _jnp_tree(tree):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def _np_tree(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["layers"])


def _ref_kept(layer, x, c):
    """The reference's kept (token, expert, slot) set, by its own rules
    (`dynamo_tpu/models/moe.py:moe_mlp`'s routing lines)."""
    T = x.shape[0]
    C = jm.expert_capacity(T, c)
    h = jm.rms_norm(x, layer["mlp_norm"], c.rms_norm_eps)
    logits = jnp.dot(h.astype(jnp.float32), layer["router"])
    topv, topi = jax.lax.top_k(logits, c.num_experts_per_tok)
    probs = jax.nn.softmax(topv, axis=-1)
    combine = jnp.zeros((T, c.num_experts), jnp.float32)
    combine = combine.at[jnp.arange(T)[:, None], topi].add(probs)
    routed = combine > 0.0
    pos = jnp.cumsum(routed.astype(jnp.int32), axis=0) - 1
    keep = np.asarray(routed & (pos < C))
    pos = np.asarray(pos)
    return {(int(t), int(e), int(pos[t, e])) for t, e in zip(*np.nonzero(keep))}


def _port_kept(layer, x, c):
    h = tm.rms_norm(x, layer["mlp_norm"], c.rms_norm_eps)
    topi, _, kept, slot = tm.route(h, layer["router"], c)
    C = tm.expert_capacity(x.shape[0], c)
    return {(int(t), int(topi[t, k]), int(slot[t, k]) % C)
            for t, k in zip(*np.nonzero(kept.numpy()))}


def _skewed_tokens(T=64, seed=1):
    """Tokens sharing a common direction, so most pick the same two
    experts and overflow their capacity."""
    rng = np.random.RandomState(seed)
    base = rng.randn(1, JCFG.hidden_size)
    return (base + 0.3 * rng.randn(T, JCFG.hidden_size)).astype(np.float32)


def test_config_presets_and_capacity_agree():
    for name in ("mixtral_8x7b", "gptoss_120b", "tiny_moe"):
        j, t = getattr(jm.MoeConfig, name)(), getattr(tm.MoeConfig, name)()
        for f in dataclasses.fields(j):
            if f.name != "dtype":
                assert getattr(j, f.name) == getattr(t, f.name), (name, f.name)
        assert t.dtype == torch.bfloat16
    for T in (1, 4, 7, 48, 64, 100, 2048):
        for cf in (1.0, 1.25, 8.0):
            assert tm.expert_capacity(T, dataclasses.replace(TCFG, capacity_factor=cf)) == \
                jm.expert_capacity(T, dataclasses.replace(JCFG, capacity_factor=cf))


def test_top_k_breaks_ties_toward_the_lower_index():
    rng = np.random.RandomState(3)
    logits = rng.randint(0, 3, size=(64, 8)).astype(np.float32)  # ties everywhere
    for k in (1, 2, 4):
        jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
        tv, ti = tm.top_k(_t(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("stacks", ["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_reference_with_drops(dtype, stacks):
    tree = numpy_params(std=0.05)
    if stacks == "int8":
        tree = _np_tree(jq.quantize_tree(_jnp_tree(tree)))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jc, tc = dataclasses.replace(JCFG, dtype=jdt), dataclasses.replace(TCFG, dtype=tdt)
    x = _skewed_tokens()
    # the router stays f32 in both trees; a quantized stack keeps int8 + f32
    jlayer = {k: (_jnp_tree(v) if isinstance(v, dict)
                  else jnp.asarray(v, jnp.float32 if k == "router" else jdt))
              for k, v in _layer0(tree).items()}
    tlayer = {k: ({"q": _t(v["q"]), "s": _t(v["s"])} if isinstance(v, dict)
                  else _t(v).to(torch.float32 if k == "router" else tdt))
              for k, v in _layer0(tree).items()}
    jx, tx = jnp.asarray(x, jdt), _t(x).to(tdt)
    want_set, got_set = _ref_kept(jlayer, jx, jc), _port_kept(tlayer, tx, tc)
    assert got_set == want_set
    C = jm.expert_capacity(x.shape[0], jc)
    routed = x.shape[0] * JCFG.num_experts_per_tok
    assert len(want_set) < routed, "the inputs must overflow an expert's capacity"
    assert max(s for _, _, s in want_set) == C - 1
    want = np.asarray(jm.moe_mlp(jlayer, jx, jc).astype(jnp.float32))
    got = tm.moe_mlp(tlayer, tx, tc)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, **(TOL if dtype == "float32" else TOL_BF16))


def test_constructed_tie_at_the_top_k_boundary():
    """Experts 1 and 2 get bit-equal logits (one nonzero router row), second
    after expert 0 (or expert 3 when the token's sign flips): the tie sits
    on the k=2 boundary, and both packages keep expert 1."""
    tree = numpy_params(std=0.05)
    router = np.zeros((JCFG.hidden_size, JCFG.num_experts), np.float32)
    router[0] = np.asarray([1.0, 0.5, 0.5, -1.0], np.float32)
    layer = _layer0(tree)
    layer["router"] = router
    x = np.random.RandomState(5).randn(16, JCFG.hidden_size).astype(np.float32)
    jlayer, tlayer = _jnp_tree(layer), {k: _t(v) for k, v in layer.items()}
    want_set, got_set = _ref_kept(jlayer, jnp.asarray(x), JCFG), _port_kept(tlayer, _t(x), TCFG)
    assert got_set == want_set
    experts = {e for _, e, _ in got_set}
    assert 1 in experts and 2 not in experts
    np.testing.assert_allclose(tm.moe_mlp(tlayer, _t(x), TCFG).numpy(),
                               np.asarray(jm.moe_mlp(jlayer, jnp.asarray(x), JCFG)), **TOL)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("spec", ["ech,ehi->eci", "eci,eih->ech"])
def test_qeinsum_matches_reference(spec, quantized):
    rng = np.random.RandomState(7)
    x = rng.randn(4, 12, 32).astype(np.float32)
    w = (rng.randn(4, 32, 24) * 0.2).astype(np.float32)
    jw = jq.quantize_array(jnp.asarray(w)) if quantized else jnp.asarray(w)
    tw = tq.quantize_array(_t(w)) if quantized else _t(w)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, TOL), (jnp.bfloat16, torch.bfloat16, TOL_BF16)):
        jwd = jw if quantized else jw.astype(jdt)
        twd = tw if quantized else tw.to(tdt)
        want = np.asarray(jq.qeinsum(spec, jnp.asarray(x, jdt), jwd))
        got = tq.qeinsum(spec, _t(x).to(tdt), twd)
        assert got.dtype == torch.float32  # the f32 result in both branches
        np.testing.assert_allclose(got.numpy(), want, **tol)
    with pytest.raises(ValueError, match="expert products"):
        tq.qeinsum("th,hi->ti", _t(x)[0], _t(w)[0])


def test_quantize_tree_quantizes_expert_stacks_bit_equal():
    tree = numpy_params()
    want = _np_tree(jq.quantize_tree(_jnp_tree(numpy_params())))
    got = tq.quantize_tree(params_from_jax(tree, device="cpu"), consume=True)
    L, E = JCFG.num_layers, JCFG.num_experts
    for name in ("w_gate", "w_up", "w_down"):
        g, w = got["layers"][name], want["layers"][name]
        assert tq.is_quant(g) and g["s"].shape == (L, E, 1, w["q"].shape[-1])
        np.testing.assert_array_equal(g["q"].numpy(), w["q"], err_msg=name)
        np.testing.assert_array_equal(g["s"].numpy(), w["s"], err_msg=name)
    assert not tq.is_quant(got["layers"]["router"])
    assert got["layers"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(got["layers"]["router"].numpy(), tree["layers"]["router"])
    # the router stays f32 when the floating leaves are cast
    half = params_from_jax(tree, dtype=torch.bfloat16, device="cpu")
    assert half["layers"]["router"].dtype == torch.float32
    assert half["layers"]["w_gate"].dtype == torch.bfloat16


# ---------------------------------------------------------------------- #
# the four forwards
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def weights():
    tree = numpy_params(std=0.05)
    return _jnp_tree(tree), params_from_jax(tree, device="cpu")


def _jit(fwd):
    """The reference forward compiled whole (the config is static)."""
    return jax.jit(fwd, static_argnums=1)


def _pool(rng, fmt, dim=None):
    """A whole [L, ...] K or V store in `fmt` for both packages: random fp
    values, or random bytes with positive scales."""
    c = JCFG
    dim = dim or c.head_dim
    shape = (c.num_layers, PAGES, PS, c.num_kv_heads, dim)
    if fmt == "none":
        x = (rng.randn(*shape) * 0.1).astype(np.float32)
        return jnp.asarray(x), _t(x.copy())
    bits = tkv.kv_quant_bits(fmt)
    rows = PS // 2 if bits == 4 else PS
    q = rng.randint(-127, 128, size=(*shape[:2], rows, *shape[3:])).astype(np.int8)
    s = (rng.rand(*shape[:2], c.num_kv_heads) * 0.01).astype(np.float32)
    return (jkv.QuantKV(jnp.asarray(q), jnp.asarray(s), bits, PS),
            tkv.QuantKV(_t(q.copy()), _t(s.copy()), bits, PS))


def _store_np(store):
    if isinstance(store, (jkv.QuantKV, tkv.QuantKV)):
        return np.asarray(store.q), np.asarray(store.s)
    return (np.asarray(store),)


def _assert_pools(tstore, jstore):
    for got, want in zip(_store_np(tstore), _store_np(jstore)):
        got, want = _real_mask_pages(got), _real_mask_pages(want)
        if got.dtype == np.int8:  # quantized rows may round one step apart
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fmt", FORMATS)
def test_prefill_forward_batched_matches(weights, fmt):
    jparams, tparams = weights
    toks, pos, tables, ctx, last = _prefill_inputs()
    rng = np.random.RandomState(10)
    (jk, tk), (jv, tv) = _pool(rng, fmt), _pool(rng, fmt)
    jlog, jk2, jv2 = _jit(jm.prefill_forward_batched)(
        jparams, JCFG8, *[jnp.asarray(a) for a in (toks, pos)], jk, jv,
        *[jnp.asarray(a) for a in (tables, ctx, last)])
    tlog, _, _ = tm.prefill_forward_batched(
        tparams, TCFG8, _t(toks), _t(pos), tk, tv, _t(tables), _t(ctx), _t(last))
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_pools(tk, jk2)
    _assert_pools(tv, jv2)


@pytest.mark.parametrize("fmt", FORMATS)
def test_ragged_forward_matches(weights, fmt):
    jparams, tparams = weights
    rng = np.random.RandomState(6)
    args = _ragged_inputs(rng.randint(3, 500, size=20).astype(np.int32), 77)
    toks, positions, row_ids, *rest = args
    (jk, tk), (jv, tv) = _pool(rng, fmt), _pool(rng, fmt)
    jlog, jk2, jv2 = _jit(jm.ragged_forward)(
        jparams, JCFG8, *[jnp.asarray(a) for a in (toks, positions, row_ids)], jk, jv,
        *[jnp.asarray(a) for a in rest])
    tlog, _, _ = tm.ragged_forward(
        tparams, TCFG8, _t(toks), _t(positions), _t(row_ids), tk, tv, *[_t(a) for a in rest])
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    _assert_pools(tk, jk2)
    _assert_pools(tv, jv2)


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_forward_matches(weights, fmt):
    jparams, tparams = weights
    rng = np.random.RandomState(4)
    B, P = 4, 3
    tables = np.zeros((B, P), np.int32)
    tables[:3] = 1 + np.arange(9).reshape(3, 3)
    positions = np.asarray([5, 16, 20, 0], np.int32)  # lane 3: inactive
    seq_lens = np.asarray([6, 17, 21, 0], np.int32)
    toks = rng.randint(3, 500, size=(B,)).astype(np.int32)
    (jk, tk), (jv, tv) = _pool(rng, fmt), _pool(rng, fmt)
    jlog, jk2, jv2 = _jit(jm.decode_forward)(
        jparams, JCFG8, *[jnp.asarray(a) for a in (toks, positions)], jk, jv,
        *[jnp.asarray(a) for a in (tables, seq_lens)])
    tlog, _, _ = tm.decode_forward(
        tparams, TCFG8, _t(toks), _t(positions), tk, tv, _t(tables), _t(seq_lens))
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    _assert_pools(tk, jk2)
    _assert_pools(tv, jv2)


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_forward_local_matches(weights, fmt):
    jparams, tparams = weights
    c = JCFG
    rng = np.random.RandomState(8)
    L, B, K, step, P = c.num_layers, 4, 4, 1, 3
    (jk, tk), (jv, tv) = _pool(rng, fmt), _pool(rng, fmt)
    tables = np.zeros((B, P), np.int32)
    tables[:3] = 1 + np.arange(9).reshape(3, 3)  # lane 3: inactive, scratch row
    pool_lens = np.asarray([5, 16, 9, 0], np.int32)
    positions = pool_lens + step
    toks = rng.randint(3, 500, size=(B,)).astype(np.int32)
    loc = (rng.randn(2, L, B, K, c.num_kv_heads, c.head_dim) * 0.5).astype(np.float32)
    jlog, jlk, jlv = _jit(jm.decode_forward_local)(
        jparams, JCFG8, jnp.asarray(toks), jnp.asarray(positions), jnp.asarray(loc[0]),
        jnp.asarray(loc[1]), jnp.asarray(step, jnp.int32), jk, jv, jnp.asarray(tables),
        jnp.asarray(pool_lens))
    tloc = _t(loc.copy())
    tlog, tlk, tlv = tm.decode_forward_local(
        tparams, TCFG8, _t(toks), _t(positions), tloc[0], tloc[1],
        torch.tensor([step], dtype=torch.int32), tk, tv, _t(tables), _t(pool_lens))
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    np.testing.assert_allclose(tlk.numpy()[:, :3], np.asarray(jlk)[:, :3], **TOL)
    np.testing.assert_allclose(tlv.numpy()[:, :3], np.asarray(jlv)[:, :3], **TOL)
