"""The port's GGUF reading and loading against the JAX reference, on the CPU.

A tiny llama .gguf written by the reference's `write_gguf` (matrices in
f32, f16 or q8_0; an embedded vocabulary) must give, through the port:
the same metadata, bit-equal `load_tensor` arrays, the same
`config_from_gguf` and `mdc_from_gguf`, and `load_llama_params_gguf`
equal to the reference's (after `params_from_jax`), with and without
`quantize="int8"`. The port's `write_gguf` writes the reference's bytes;
`GgufTokenizer` encodes and decodes as the reference's does; a file the
port's `save_llama_as_gguf` writes loads the same in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.llm import gguf as jg
from dynamo_tpu.llm.tokenizers import load_tokenizer as ref_load_tokenizer
from dynamo_tpu.models import loader as jload
from dynamo_tpu_torch.engine import UnsupportedConfigError
from dynamo_tpu_torch.llm import gguf as tg
from dynamo_tpu_torch.llm.tokenizers import GgufTokenizer, load_tokenizer
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import loader as tload
from dynamo_tpu_torch.models.convert import params_from_jax
from tests.test_torch_loader import _assert_trees_equal

TYPES = {"f32": jg.GGML_F32, "f16": jg.GGML_F16, "q8_0": jg.GGML_Q8_0}
VOCAB = (["<unk>", "<s>", "</s>", "▁", "hello", "▁world", "wor", "ld", "▁the"]
         + [chr(c) for c in range(ord("a"), ord("z") + 1)])
CFG = dict(vocab_size=512, hidden_size=64, intermediate_size=96, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, rope_theta=10000.0, max_position=512)


def llama_tensors(seed=0, tied=False):
    """HF-orientation llama.cpp tensors of a tiny model (numpy f32)."""
    rng = np.random.RandomState(seed)
    c = CFG
    H, I, L = c["hidden_size"], c["intermediate_size"], c["num_layers"]
    q, kv = c["num_heads"] * c["head_dim"], c["num_kv_heads"] * c["head_dim"]
    w = lambda *s: (rng.randn(*s) * 0.15).astype(np.float32)  # noqa: E731
    t = {"token_embd.weight": w(c["vocab_size"], H), "output_norm.weight": 1 + w(H)}
    if not tied:
        t["output.weight"] = w(c["vocab_size"], H)
    for li in range(L):
        t.update({f"blk.{li}.attn_norm.weight": 1 + w(H), f"blk.{li}.attn_q.weight": w(q, H),
                  f"blk.{li}.attn_k.weight": w(kv, H), f"blk.{li}.attn_v.weight": w(kv, H),
                  f"blk.{li}.attn_output.weight": w(H, q), f"blk.{li}.ffn_norm.weight": 1 + w(H),
                  f"blk.{li}.ffn_gate.weight": w(I, H), f"blk.{li}.ffn_up.weight": w(I, H),
                  f"blk.{li}.ffn_down.weight": w(H, I)})
    return t


def llama_metadata():
    c = CFG
    vocab = VOCAB + [f"<x{i}>" for i in range(c["vocab_size"] - len(VOCAB))]
    return {
        "general.architecture": "llama", "general.name": "tiny-gguf",
        "llama.block_count": c["num_layers"], "llama.context_length": c["max_position"],
        "llama.embedding_length": c["hidden_size"], "llama.attention.head_count": c["num_heads"],
        "llama.attention.head_count_kv": c["num_kv_heads"],
        "llama.attention.key_length": c["head_dim"], "llama.rope.freq_base": c["rope_theta"],
        "llama.attention.layer_norm_rms_epsilon": 1e-5,
        "tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": vocab,
        "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.chat_template": "{{ messages }}",
    }


def write_reference_gguf(path, ttype: str, tied=False, seed=0):
    tensors = llama_tensors(seed, tied)
    types = {k: TYPES[ttype] for k, v in tensors.items() if v.ndim == 2}
    jg.write_gguf(path, llama_metadata(), tensors=tensors, tensor_types=types)
    return tensors


@pytest.fixture(scope="module", params=["f32", "f16", "q8_0"])
def gguf_file(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("gguf") / f"tiny-{request.param}.gguf"
    write_reference_gguf(path, request.param)
    return str(path)


def test_metadata_tensors_and_config_equal_the_reference(gguf_file):
    want, got = jg.read_gguf(gguf_file, with_tensors=True), tg.read_gguf(gguf_file, with_tensors=True)
    assert got.metadata == want.metadata and got.data_start == want.data_start
    assert {k: dataclasses.astuple(v) for k, v in got.tensors.items()} == \
        {k: dataclasses.astuple(v) for k, v in want.tensors.items()}
    for name in want.tensors:
        a, b = tg.load_tensor(got, name), jg.load_tensor(want, name)
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=name)
    jc, tc = jload.config_from_gguf(want), tload.config_from_gguf(got)
    for f in dataclasses.fields(tc):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc == tl.LlamaConfig(**CFG, tie_embeddings=False)
    assert tg.mdc_from_gguf(gguf_file, 16).__dict__ == jg.mdc_from_gguf(gguf_file, 16).__dict__


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
def test_load_llama_params_gguf_equals_the_reference(gguf_file, quantize):
    jcfg = dataclasses.replace(jload.config_from_gguf(gguf_file), dtype=jnp.float32)
    tcfg = dataclasses.replace(tload.config_from_gguf(gguf_file), dtype=torch.float32)
    want = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                        jload.load_llama_params_gguf(gguf_file, jcfg, quantize=quantize),
                        is_leaf=lambda a: a is None)
    got = tload.load_llama_params_gguf(gguf_file, tcfg, quantize=quantize, device="cpu")
    _assert_trees_equal(got, params_from_jax(want, device="cpu"))
    # the safetensors entry point takes the GGUF branch for a .gguf path
    again = tload.load_llama_params(gguf_file, tcfg, quantize=quantize, device="cpu")
    _assert_trees_equal(again, got)


def test_write_gguf_writes_the_reference_bytes(tmp_path):
    tensors = llama_tensors(3)
    tensors["odd"] = np.arange(5, dtype=np.float32)  # not a whole q8_0 block: f32
    types = {k: jg.GGML_Q8_0 for k, v in tensors.items() if v.ndim == 2}
    types["blk.0.attn_norm.weight"] = jg.GGML_F16
    jg.write_gguf(tmp_path / "ref.gguf", llama_metadata(), tensors=tensors, tensor_types=types)
    tg.write_gguf(tmp_path / "port.gguf", llama_metadata(), tensors=tensors, tensor_types=types)
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "ref.gguf").read_bytes()


def test_port_gguf_export_loads_the_same_in_both(tmp_path):
    cfg = tl.LlamaConfig(**CFG, dtype=torch.float32, tie_embeddings=True)
    params = tl.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    path = str(tmp_path / "port.gguf")
    tload.save_llama_as_gguf(params, cfg, path, tokens=llama_metadata()["tokenizer.ggml.tokens"])
    assert tload._find_gguf(str(tmp_path)) == path
    assert tload.config_from_gguf(path) == dataclasses.replace(cfg, dtype=torch.bfloat16)
    jcfg = dataclasses.replace(jload.config_from_gguf(path), dtype=jnp.float32)
    want = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                        jload.load_llama_params_gguf(path, jcfg), is_leaf=lambda a: a is None)
    got = tload.load_llama_params_gguf(path, cfg, device="cpu")
    _assert_trees_equal(got, params_from_jax(want, device="cpu"))
    assert got["lm_head"] is None
    # q8_0 keeps each weight within half a step of its 32-value group
    step = params["layers"]["wq"].abs().amax() / 127
    assert (got["layers"]["wq"] - params["layers"]["wq"]).abs().max() <= step / 2 + 1e-6


def test_gguf_tokenizer_encodes_and_decodes_as_the_reference(gguf_file):
    ours, theirs = load_tokenizer(f"gguf:{gguf_file}"), ref_load_tokenizer(f"gguf:{gguf_file}")
    assert isinstance(ours, GgufTokenizer)
    for text in ["hello world", "the world", " hello  the worldz!", "", "wor ld"]:
        ids = ours.encode(text)
        assert ids == theirs.encode(text), text
        assert ours.decode(ids) == theirs.decode(ids)
        assert ours.decode(ids, skip_special_tokens=False) == theirs.decode(ids, False)
    assert ours.decode([1, 4, 5, 2, 63]) == theirs.decode([1, 4, 5, 2, 63]) == "hello world"
    stream = ours.decode_stream()
    assert "".join(filter(None, (stream.step(i) for i in ours.encode("hello world")))) \
        == "hello world"
    assert (ours.vocab_size, ours.eos_token_ids, ours.bos_token_id) == \
        (theirs.vocab_size, theirs.eos_token_ids, theirs.bos_token_id)
    assert load_tokenizer("byte:300").vocab_size == 300


def test_refusals(tmp_path):
    (tmp_path / "tokenizer.json").write_text("{}")
    with pytest.raises(UnsupportedConfigError, match="tokenizer.json"):
        load_tokenizer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_tokenizer(str(tmp_path / "missing.json"))
    moe = llama_tensors()
    moe["blk.0.ffn_gate_inp.weight"] = np.zeros((4, 64), np.float32)
    jg.write_gguf(tmp_path / "moe.gguf", llama_metadata(), tensors=moe)
    # an MoE gguf must state its expert counts (tests/test_torch_moe_loader.py
    # loads one that does)
    with pytest.raises(ValueError, match="MoE gguf missing llama.expert_count"):
        tload.config_from_gguf(str(tmp_path / "moe.gguf"))
    (tmp_path / "not.gguf").write_bytes(b"NOPE" + bytes(20))
    with pytest.raises(ValueError, match="not a GGUF"):
        tg.read_gguf(tmp_path / "not.gguf")
