"""The port's multi-LoRA functions against the JAX reference, on the CPU.

Function level: `lora_delta` (2-D and 3-D), `stack_adapters` (zero base
slot, rank padding, scales), the PEFT loader (a safetensors and a .bin
export written here, and the reference's refusals), and the three LoRA
forwards (`prefill_forward_batched`, `ragged_forward` with per-row slots
among base rows, `decode_forward`) on a tiny f32 Llama with a stack of two
adapters of different ranks, carried across with `adapter_from_jax`.
Tolerance 2e-3 (f32 summation order differs between XLA and PyTorch).
`LoraPool` against the reference pool over one scripted sequence of
acquires, releases, registrations and an injected `lora.onboard` error:
the same slots, refusals and counters.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl, lora as jlora, lora_pool as jpool
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu_torch.models import llama as tl, lora as tlora, lora_pool as tpool
from dynamo_tpu_torch.models.convert import adapter_from_jax, params_from_jax
from dynamo_tpu_torch.models.safetensors_io import save_file
from dynamo_tpu_torch.runtime import faults as tfaults

from .test_torch_llama import _pools, _prefill_inputs, _ragged_inputs, _real_mask_pages, _t

TOL = dict(rtol=2e-3, atol=2e-3)
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jparams)
    tree["lm_head"] = None if jparams["lm_head"] is None else np.asarray(jparams["lm_head"])
    return jparams, params_from_jax(tree, device="cpu")


@pytest.fixture(scope="module")
def adapters():
    """Two reference adapters of ranks 4 and 8 (the second without wk) with
    scales 2 and 0.5, and the same two in the port."""
    ref = [
        jlora.init_adapter(JCFG, "ad1", jax.random.PRNGKey(101), rank=4, scale=2.0),
        jlora.init_adapter(JCFG, "ad2", jax.random.PRNGKey(202), rank=8, scale=0.5,
                           targets=("wq", "wv", "wo")),
    ]
    return ref, [adapter_from_jax(a, device="cpu") for a in ref]


def _jax_operand(stack, idx):
    return {"a": stack["a"], "b": stack["b"], "scale": stack["scale"],
            "idx": jnp.asarray(idx, jnp.int32)}


def _torch_operand(stack, idx):
    return dict(stack, idx=torch.as_tensor(np.asarray(idx, np.int32)))


# ---------------------------------------------------------------------- #
# function level
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("lead", [(3,), (3, 5)], ids=["2d", "3d"])
def test_lora_delta_matches_reference(lead):
    rng = np.random.RandomState(0)
    din, dout, r, N = 16, 24, 4, 3
    h = rng.randn(*lead, din).astype(np.float32)
    A = rng.randn(N, din, r).astype(np.float32)
    B = rng.randn(N, r, dout).astype(np.float32)
    scale = np.asarray([1.0, 2.0, 0.5], np.float32)
    idx = np.asarray([2, 0, 1], np.int32)
    want = np.asarray(jlora.lora_delta(*[jnp.asarray(a) for a in (h, A, B, idx, scale)]))
    got = tlora.lora_delta(_t(h), _t(A).permute(1, 0, 2), _t(B), _t(idx), _t(scale))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_stack_adapters_match_reference(adapters):
    ref, ours = adapters
    want = jlora.stack_adapters(JCFG, ref)
    got = tlora.stack_adapters(TCFG, ours)
    assert got["names"] == want["names"] == {"ad1": 1, "ad2": 2}
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    assert got["scale"].dtype == torch.float32
    for t in tlora.TARGETS:
        # ours [L, in, N, r] / [L, N, r, out]; the reference's [N, L, in, r] / [N, L, r, out]
        np.testing.assert_array_equal(got["a"][t].permute(2, 0, 1, 3).numpy(),
                                      np.asarray(want["a"][t]))
        np.testing.assert_array_equal(got["b"][t].permute(1, 0, 2, 3).numpy(),
                                      np.asarray(want["b"][t]))
        assert got["a"][t].shape[-1] == 8  # padded to the largest rank
        assert not got["a"][t][:, :, 0].any() and not got["b"][t][:, 0].any()
    assert not got["a"]["wk"][:, :, 2].any()  # ad2 has no wk delta


def test_init_adapter_is_seeded_and_nonzero():
    a = tlora.init_adapter(TCFG, "x", torch.Generator().manual_seed(3), rank=4)
    b = tlora.init_adapter(TCFG, "x", torch.Generator().manual_seed(3), rank=4)
    c = tlora.init_adapter(TCFG, "x", torch.Generator().manual_seed(4), rank=4)
    dims = tlora.target_dims(TCFG)
    for t in tlora.TARGETS:
        assert tuple(a.a[t].shape) == (TCFG.num_layers, dims[t][0], 4)
        assert tuple(a.b[t].shape) == (TCFG.num_layers, 4, dims[t][1])
        assert torch.equal(a.a[t], b.a[t]) and torch.equal(a.b[t], b.b[t])
        assert not torch.equal(a.a[t], c.a[t])
        assert a.b[t].abs().max() > 0


def _peft_state(r, layers, targets=("q_proj", "v_proj"), seed=7):
    dims = jlora.target_dims(JCFG)
    rng = np.random.RandomState(seed)
    state = {}
    for li in layers:
        for peft_t in targets:
            din, dout = dims[jlora._PEFT_NAMES[peft_t]]
            pre = f"base_model.model.model.layers.{li}.self_attn.{peft_t}"
            state[f"{pre}.lora_A.weight"] = rng.randn(r, din).astype(np.float32)
            state[f"{pre}.lora_B.weight"] = rng.randn(dout, r).astype(np.float32)
    return state


def _write_peft(d, state, r, alpha, fmt):
    d.mkdir()
    if fmt == "safetensors":
        save_file(state, d / "adapter_model.safetensors")
    elif fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in state.items()},
                   d / "adapter_model.bin")
    (d / "adapter_config.json").write_text(json.dumps({"r": r, "lora_alpha": alpha}))
    return str(d)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_peft_export_loads_equal(tmp_path, fmt):
    path = _write_peft(tmp_path / "peft", _peft_state(4, range(JCFG.num_layers)), 4, 8.0, fmt)
    want = jlora.load_peft_adapter(path, JCFG, name="mine")
    got = tlora.load_peft_adapter(path, TCFG, name="mine")
    assert (got.name, got.rank, got.scale) == (want.name, want.rank, want.scale) == ("mine", 4, 2.0)
    assert set(got.a) == set(want.a) == {"wq", "wv"}
    for t in got.a:
        np.testing.assert_array_equal(got.a[t].numpy(), np.asarray(want.a[t]))
        np.testing.assert_array_equal(got.b[t].numpy(), np.asarray(want.b[t]))
    assert tlora.load_peft_adapter(path, TCFG).name == "peft"  # the directory's name


@pytest.mark.parametrize("case", ["layers", "shape", "targets", "missing"])
def test_peft_loader_refusals_match(tmp_path, case):
    L = JCFG.num_layers
    state, r = {
        "layers": (_peft_state(4, range(L - 1)), 4),  # a target on 1 of 2 layers
        "shape": (_peft_state(4, range(L)), 8),  # config rank differs from the tensors
        "targets": ({"base_model.model.model.layers.0.mlp.gate_proj.lora_A.weight":
                     np.zeros((4, 64), np.float32)}, 4),
        "missing": ({}, 4),
    }[case]
    path = _write_peft(tmp_path / "peft", state, r, 8.0,
                       "none" if case == "missing" else "safetensors")
    with pytest.raises((ValueError, FileNotFoundError)) as want:
        jlora.load_peft_adapter(path, JCFG)
    with pytest.raises(want.type) as got:
        tlora.load_peft_adapter(path, TCFG)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------- #
# forwards with an adapter stack
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def stacks(adapters):
    ref, ours = adapters
    return jlora.stack_adapters(JCFG, ref), tlora.stack_adapters(TCFG, ours)


def _forward(kind, params, cfg, mod, arrays, lora, pools):
    k, v = pools
    if kind == "prefill":
        toks, pos, tables, ctx, last = arrays
        return mod.prefill_forward_batched(params, cfg, toks, pos, k, v, tables, ctx, last,
                                           lora=lora)
    if kind == "ragged":
        toks, pos, row_ids, *rest = arrays
        return mod.ragged_forward(params, cfg, toks, pos, row_ids, k, v, *rest, lora=lora)
    toks, pos, tables, seq_lens = arrays
    return mod.decode_forward(params, cfg, toks, pos, k, v, tables, seq_lens, lora=lora)


def _inputs(kind):
    rng = np.random.RandomState(6)
    if kind == "prefill":
        return _prefill_inputs(), np.asarray([1, 0, 2], np.int32), 3
    if kind == "ragged":
        # rows: a prefill chunk on ad2, a base decode row, a chunk on ad1
        return (_ragged_inputs(rng.randint(3, 500, size=20).astype(np.int32), 77),
                np.asarray([2, 0, 1, 0], np.int32), 3)
    B, P = 4, 3
    tables = np.zeros((B, P), np.int32)
    tables[:3] = 1 + np.arange(9).reshape(3, 3)
    return ((rng.randint(3, 500, size=(B,)).astype(np.int32),
             np.asarray([5, 16, 9, 0], np.int32), tables,
             np.asarray([6, 17, 10, 0], np.int32)), np.asarray([2, 1, 0, 0], np.int32), 3)


@pytest.mark.parametrize("kind", ["prefill", "ragged", "decode"])
def test_lora_forwards_match_reference(weights, stacks, kind):
    jparams, tparams = weights
    jstack, tstack = stacks
    arrays, idx, n_real = _inputs(kind)
    k0, v0 = _pools()
    jlog, jk, _ = _forward(kind, jparams, JCFG, jl, [jnp.asarray(a) for a in arrays],
                           _jax_operand(jstack, idx), (jnp.asarray(k0), jnp.asarray(v0)))
    tk, tv = _t(k0.copy()), _t(v0.copy())
    tlog, _, _ = _forward(kind, tparams, TCFG, tl, [_t(a) for a in arrays],
                          _torch_operand(tstack, idx), (tk, tv))
    np.testing.assert_allclose(tlog.numpy()[:n_real], np.asarray(jlog)[:n_real], **TOL)
    np.testing.assert_allclose(_real_mask_pages(tk.numpy()), _real_mask_pages(np.asarray(jk)),
                               **TOL)
    # base rows/lanes (slot 0) equal the forward without adapters, exactly;
    # adapter rows differ from it
    bk, bv = _t(k0.copy()), _t(v0.copy())
    base, _, _ = _forward(kind, tparams, TCFG, tl, [_t(a) for a in arrays], None, (bk, bv))
    zero, _, _ = _forward(kind, tparams, TCFG, tl, [_t(a) for a in arrays],
                          _torch_operand(tstack, np.zeros_like(idx)),
                          (_t(k0.copy()), _t(v0.copy())))
    assert torch.equal(zero, base)
    for i in range(n_real):
        if idx[i] == 0:
            assert torch.equal(tlog[i], base[i])
        else:
            assert not torch.allclose(tlog[i], base[i])


# ---------------------------------------------------------------------- #
# the adapter pool
# ---------------------------------------------------------------------- #


def _pool_roster():
    return [jlora.init_adapter(JCFG, n, jax.random.PRNGKey(i), rank=4)
            for i, n in enumerate(["a", "b", "c"], start=11)]


def _run_script(pool_cls, err_cls, fault_mod, cfg, roster, extra):
    """One scripted sequence; returns each step's slot or refusal text and
    the pool's counters (timing keys dropped)."""
    pool = pool_cls(cfg, roster, slots=2)
    log = [dict(pool.stack["names"])]

    def acquire(name):
        try:
            log.append(("slot", name, pool.acquire(name)))
        except err_cls as e:
            log.append(("refused", name, str(e)))

    acquire("a")  # hit (onboarded at registration)
    acquire("c")  # miss: evicts the unpinned b
    acquire("b")  # miss, every slot pinned: refused
    pool.release("a")
    acquire("b")  # miss: evicts a
    acquire("zz")  # unknown
    pool.release("c")
    fault_mod.configure("lora.onboard:error,times=1")
    try:
        acquire("a")  # miss: evicts c, the onboard fails
    finally:
        fault_mod.reset()
    acquire("a")  # onboards into the freed slot
    pool.register(extra)  # same rank: no rebuild, no free slot to fill
    pool.release("a")
    pool.release("b")
    acquire("d")
    acquire("b")
    log.append(dict(pool.stack["names"]))
    stats = {k: v for k, v in pool.stats().items() if "_ms" not in k}
    return log, stats, pool


def test_pool_script_matches_reference():
    roster = _pool_roster()
    extra = jlora.init_adapter(JCFG, "d", jax.random.PRNGKey(14), rank=4)
    want, want_stats, _ = _run_script(jpool.LoraPool, jpool.LoraPoolError, jfaults, JCFG,
                                      roster, [extra])
    got, got_stats, pool = _run_script(
        tpool.LoraPool, tpool.LoraPoolError, tfaults, TCFG,
        [adapter_from_jax(a, device="cpu") for a in roster],
        [adapter_from_jax(extra, device="cpu")])
    assert got == want
    assert got_stats == want_stats
    assert [e[0] for e in got[1:-1]].count("refused") == 3
    assert got_stats["lora_pool_refusals"] == 2  # pinned-full + injected
    assert pool.pinned() == 2  # d and b live
    # the onboards queued their rows; land() writes them: the device rows of
    # every resident adapter are its weights
    assert pool.landing()
    pool.land()
    assert not pool.landing()
    for name, slot in pool.stack["names"].items():
        ad = pool._host[name]
        assert torch.equal(pool.stack["a"]["wq"][:, :, slot], ad.a["wq"])
        assert float(pool.stack["scale"][slot]) == ad.scale


def test_pool_rebuild_keeps_resident_slots():
    """A rank that grows rebuilds the stack: every resident adapter keeps
    its slot (a pinned stream's index stays valid), zero-padded."""
    g = torch.Generator().manual_seed(0)
    roster = [tlora.init_adapter(TCFG, n, g, rank=4) for n in ("a", "b", "c")]
    pool = tpool.LoraPool(TCFG, roster, slots=2)
    pool.acquire("a")
    pool.release("b")
    pool.release("a")
    pool.acquire("b")
    pool.acquire("c")  # evicts a; c takes a's slot
    before = dict(pool.stack["names"])
    stack = pool.stack
    pool.register([tlora.init_adapter(TCFG, "big", g, rank=8)])
    pool.land()
    assert pool.stack is stack and stack["a"]["wq"].shape[-1] == 8
    assert {k: stack["names"][k] for k in before} == before
    for name, slot in before.items():
        ad = pool._host[name]
        assert torch.equal(stack["b"]["wo"][:, slot, :4], ad.b["wo"])
        assert not stack["b"]["wo"][:, slot, 4:].any()
