"""The port's MoE checkpoint loading against the JAX reference, on the CPU.

  * a Mixtral-named safetensors checkpoint (router
    `block_sparse_moe.gate`, experts `experts.N.w1/w3/w2`), written by hand
    as tests/test_loader.py writes it, loads in the port equal to
    `params_from_jax(reference load_moe_params(...))`, f32 and int8 (the
    expert stacks quantized per (layer, expert), bit for bit; the router
    f32); the port's `save_moe_as_hf` export loads back the same in both;
  * an MoE .gguf (llama.cpp's `ffn_{gate,up,down}_exps` and `ffn_gate_inp`)
    written with the reference's `write_gguf` gives the same MoeConfig in
    both packages and loads the same, f32 and int8; the port's MoE
    `save_llama_as_gguf` export loads the same in both;
  * a second oracle: a random-config `transformers.MixtralForCausalLM`
    saved with `save_pretrained` loads in the port, whose prefill logits
    agree with transformers' within 2e-3 (f32) at a capacity factor where
    nothing drops (transformers' Mixtral has no capacity bound), and whose
    config.json gives the depth (`depth_from_hf`).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from dynamo_tpu.llm import gguf as jg
from dynamo_tpu.models import loader as jload
from dynamo_tpu.models import moe as jm
from dynamo_tpu_torch.models import loader as tload
from dynamo_tpu_torch.models import moe as tm
from dynamo_tpu_torch.models import quant as tq
from dynamo_tpu_torch.models.convert import params_from_jax
from tests.test_torch_loader import _assert_trees_equal

JCFG = jm.MoeConfig.tiny_moe(dtype=jnp.float32, tie_embeddings=False)
TCFG = tm.MoeConfig.tiny_moe(dtype=torch.float32, tie_embeddings=False)


def _np(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


@pytest.fixture(scope="module")
def moe_params():
    return _np(jm.init_params(JCFG, jax.random.PRNGKey(0)))


def _write_mixtral(params, d):
    """The tree in Mixtral's HF naming, f32, one file (by hand)."""
    f32t = lambda x: np.ascontiguousarray(np.asarray(x, np.float32).T)  # noqa: E731
    L = params["layers"]
    tensors = {"model.embed_tokens.weight": params["embed"],
               "model.norm.weight": params["final_norm"],
               "lm_head.weight": f32t(params["lm_head"])}
    for li in range(JCFG.num_layers):
        pre = f"model.layers.{li}"
        tensors[f"{pre}.input_layernorm.weight"] = L["attn_norm"][li]
        tensors[f"{pre}.post_attention_layernorm.weight"] = L["mlp_norm"][li]
        for name, key in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv"), ("o_proj", "wo")):
            tensors[f"{pre}.self_attn.{name}.weight"] = f32t(L[key][li])
        tensors[f"{pre}.block_sparse_moe.gate.weight"] = f32t(L["router"][li])
        for e in range(JCFG.num_experts):
            for w, key in (("w1", "w_gate"), ("w3", "w_up"), ("w2", "w_down")):
                tensors[f"{pre}.block_sparse_moe.experts.{e}.{w}.weight"] = f32t(L[key][li, e])
    d.mkdir(exist_ok=True)
    np_save_file({k: np.ascontiguousarray(v, np.float32) for k, v in tensors.items()},
                 str(d / "model.safetensors"))
    return d


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
def test_mixtral_safetensors_load_equals_the_reference_load(tmp_path, moe_params, quantize):
    d = _write_mixtral(moe_params, tmp_path / "ckpt")
    want = params_from_jax(_np(jload.load_moe_params(str(d), JCFG, quantize=quantize)),
                           device="cpu")
    got = tload.load_moe_params(str(d), TCFG, quantize=quantize, device="cpu")
    _assert_trees_equal(got, want)
    L = got["layers"]
    assert L["router"].dtype == torch.float32 and not tq.is_quant(L["router"])
    if quantize:
        assert L["w_gate"]["s"].shape == (JCFG.num_layers, JCFG.num_experts, 1,
                                          JCFG.intermediate_size)
        # per (layer, expert) quantization equals quantize_tree of the weights
        _assert_trees_equal(got, tq.quantize_tree(params_from_jax(moe_params, device="cpu")))
    else:
        _assert_trees_equal(got, params_from_jax(moe_params, device="cpu"))
    # the dense loader refuses it
    with pytest.raises(ValueError, match="MoE checkpoint"):
        tload.load_llama_params(str(d), TCFG, device="cpu")


def test_port_moe_export_round_trips_through_both_loaders(tmp_path, moe_params):
    params = params_from_jax(moe_params, device="cpu")
    files = tload.save_moe_as_hf(params, TCFG, str(tmp_path / "ours"), max_shard_bytes=1 << 16)
    assert len(files) > 2  # index-sharded
    _assert_trees_equal(tload.load_moe_params(str(tmp_path / "ours"), TCFG, device="cpu"), params)
    # one f32 file the reference reads as its own
    tload.save_moe_as_hf(params, TCFG, str(tmp_path / "one"))
    theirs = params_from_jax(_np(jload.load_moe_params(str(tmp_path / "one"), JCFG)),
                             device="cpu")
    _assert_trees_equal(theirs, params)


def _moe_gguf_tensors(params):
    """The tree in llama.cpp's MoE naming (tests/test_loader.py's layout)."""
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    swap = lambda x: np.ascontiguousarray(np.swapaxes(f32(x), -1, -2))  # noqa: E731
    L = params["layers"]
    tensors = {"token_embd.weight": f32(params["embed"]),
               "output_norm.weight": f32(params["final_norm"]),
               "output.weight": swap(params["lm_head"])}
    for li in range(JCFG.num_layers):
        pre = f"blk.{li}"
        tensors[f"{pre}.attn_norm.weight"] = f32(L["attn_norm"][li])
        tensors[f"{pre}.ffn_norm.weight"] = f32(L["mlp_norm"][li])
        for name, key in (("attn_q", "wq"), ("attn_k", "wk"), ("attn_v", "wv"),
                          ("attn_output", "wo"), ("ffn_gate_inp", "router"),
                          ("ffn_gate_exps", "w_gate"), ("ffn_up_exps", "w_up"),
                          ("ffn_down_exps", "w_down")):
            tensors[f"{pre}.{name}.weight"] = swap(L[key][li])
    return tensors


def _moe_gguf_metadata():
    c = JCFG
    return {
        "general.architecture": "llama", "llama.block_count": c.num_layers,
        "llama.attention.head_count": c.num_heads,
        "llama.attention.head_count_kv": c.num_kv_heads,
        "llama.attention.key_length": c.head_dim, "llama.embedding_length": c.hidden_size,
        "llama.context_length": 256, "llama.rope.freq_base": c.rope_theta,
        "llama.expert_count": c.num_experts, "llama.expert_used_count": c.num_experts_per_tok,
    }


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
def test_moe_gguf_config_and_load_equal_the_reference(tmp_path, moe_params, quantize):
    path = tmp_path / "moe.gguf"
    jg.write_gguf(path, _moe_gguf_metadata(), tensors=_moe_gguf_tensors(moe_params))
    derived, ref_derived = tload.config_from_gguf(str(path)), jload.config_from_gguf(str(path))
    assert isinstance(derived, tm.MoeConfig) and isinstance(ref_derived, jm.MoeConfig)
    for f in ("num_experts", "num_experts_per_tok", "intermediate_size", "hidden_size",
              "num_layers", "num_heads", "num_kv_heads", "head_dim", "vocab_size",
              "tie_embeddings", "max_position"):
        assert getattr(derived, f) == getattr(ref_derived, f), f
    cfg = tm.MoeConfig(**{f: getattr(derived, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
        "num_kv_heads", "head_dim", "rope_theta", "rms_norm_eps", "max_position",
        "tie_embeddings", "num_experts", "num_experts_per_tok")}, dtype=torch.float32)
    want = params_from_jax(_np(jload.load_moe_params(
        str(path), jm.MoeConfig(**{**ref_derived.__dict__, "dtype": jnp.float32}),
        quantize=quantize)), device="cpu")
    got = tload.load_moe_params(str(path), cfg, quantize=quantize, device="cpu")
    _assert_trees_equal(got, want)
    assert got["layers"]["router"].dtype == torch.float32
    if quantize is None:
        _assert_trees_equal(got, params_from_jax(moe_params, device="cpu"))


def test_port_moe_gguf_export_loads_the_same_in_both(tmp_path, moe_params):
    params = params_from_jax(moe_params, device="cpu")
    path = tmp_path / "ours.gguf"
    tload.save_llama_as_gguf(params, TCFG, str(path), tensor_type=jg.GGML_F32)
    cfg = tload.config_from_gguf(str(path))
    assert isinstance(cfg, tm.MoeConfig) and cfg.num_experts == TCFG.num_experts
    cfg = tm.MoeConfig(**{**cfg.__dict__, "dtype": torch.float32})
    got = tload.load_moe_params(str(path), cfg, device="cpu")
    _assert_trees_equal(got, params)
    jcfg = jm.MoeConfig(**{**jload.config_from_gguf(str(path)).__dict__, "dtype": jnp.float32})
    _assert_trees_equal(params_from_jax(_np(jload.load_moe_params(str(path), jcfg)),
                                        device="cpu"), params)


def test_hf_transformers_mixtral_prefill_logits_agree(tmp_path):
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(7)
    hf_cfg = MixtralConfig(
        vocab_size=512, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rms_norm_eps=1e-5, rope_theta=1e6, num_local_experts=4, num_experts_per_tok=2,
        router_jitter_noise=0.0, tie_word_embeddings=False, torch_dtype=torch.float32,
    )
    model = MixtralForCausalLM(hf_cfg).eval()
    model.save_pretrained(tmp_path, safe_serialization=True)
    prompts = [[7, 42, 101, 9, 250, 33, 17, 5, 300, 12, 8], [3, 99, 4]]
    with torch.no_grad():
        want = [model(torch.tensor([p])).logits[0, -1] for p in prompts]

    # transformers' Mixtral drops nothing: a capacity factor where nothing drops
    cfg = tload.depth_from_hf(str(tmp_path), tm.MoeConfig.tiny_moe(
        dtype=torch.float32, num_layers=8, capacity_factor=8.0))
    assert cfg.num_layers == 2  # config.json's num_hidden_layers
    params = tload.load_moe_params(str(tmp_path), cfg, device="cpu")
    ps, T, P = 8, 16, 4
    toks = np.zeros((2, T), np.int32)
    pos = np.full((2, T), P * ps - 1, np.int32)
    for b, p in enumerate(prompts):
        toks[b, : len(p)], pos[b, : len(p)] = p, np.arange(len(p))
    tables = np.zeros((2, P), np.int32)
    tables[:, :2] = [[1, 2], [3, 4]]
    kv = [torch.zeros(cfg.num_layers, 6, ps, cfg.num_kv_heads, cfg.head_dim) for _ in range(2)]
    logits, _, _ = tm.prefill_forward_batched(
        params, cfg, torch.from_numpy(toks), torch.from_numpy(pos), *kv,
        torch.from_numpy(tables), torch.zeros(2, dtype=torch.int32),
        torch.tensor([len(p) - 1 for p in prompts], dtype=torch.int32))
    torch.testing.assert_close(logits, torch.stack(want), rtol=2e-3, atol=2e-3)
    assert [int(x) for x in logits.argmax(-1)] == [int(w.argmax()) for w in want]
    # the widths config.json states must be the model's
    (tmp_path / "config.json").write_text(json.dumps(
        {**json.loads((tmp_path / "config.json").read_text()), "num_local_experts": 8}))
    with pytest.raises(ValueError, match="num_local_experts=8"):
        tload.depth_from_hf(str(tmp_path), cfg)
