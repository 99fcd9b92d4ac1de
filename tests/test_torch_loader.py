"""The port's checkpoint loading against the JAX reference, on the CPU.

  * `models/safetensors_io.py` and the `safetensors` package read each
    other's files, in F32, F16 and BF16, bit for bit;
  * a reference `save_llama_as_hf` directory (one file, or re-written as
    index-sharded shards) loads in the port equal to
    `params_from_jax(reference load_llama_params(...))`, bf16 and int8
    (the int8 load equals `quantize_tree` of the saved weights);
  * `resolve_model_path` resolves a fake HF hub cache as the reference
    does, and refuses a missing path, an uncached repo and a download;
  * a second oracle: a random-config `transformers.LlamaForCausalLM`
    saved with `save_pretrained` loads in the port, whose prefill logits
    agree with transformers' within 2e-3 (f32).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file, save_file as np_save_file
from safetensors.torch import load_file as st_load, save_file as st_save

from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import loader as jload
from dynamo_tpu_torch.engine import UnsupportedConfigError
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import loader as tload
from dynamo_tpu_torch.models import quant as tq
from dynamo_tpu_torch.models import safetensors_io as sio
from dynamo_tpu_torch.models.convert import params_from_jax

TCFG = tl.LlamaConfig.tiny(dtype=torch.float32, tie_embeddings=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["F32", "F16", "BF16"])
def test_safetensors_files_interchange_with_the_package(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(6, 10, generator=g).to(dtype),
               "b": torch.randn(7, generator=g).to(dtype),
               "c.scalar": torch.randn((), generator=g).to(dtype),
               "empty": torch.zeros(0, 3, dtype=dtype)}
    sio.save_file(tensors, tmp_path / "ours.safetensors", {"format": "pt"})
    theirs = st_load(tmp_path / "ours.safetensors")
    for k, t in tensors.items():
        assert theirs[k].dtype == dtype and torch.equal(theirs[k], t), k
    st_save(tensors, tmp_path / "theirs.safetensors", metadata={"format": "pt"})
    f = sio.SafetensorsFile(tmp_path / "theirs.safetensors")
    assert sorted(f.keys()) == sorted(tensors) and f.metadata == {"format": "pt"}
    for k, t in tensors.items():
        got = f.get(k)
        assert got.dtype == dtype and f.shape(k) == tuple(t.shape)
        assert torch.equal(got, t), k
    # a cast on write, and the sharded layout the package's reader follows
    names = sio.save_sharded(tensors, tmp_path / "sh", max_shard_bytes=64, dtype=torch.bfloat16)
    index = json.loads((tmp_path / "sh" / sio.INDEX_NAME).read_text())
    assert len(names) > 2 and set(index["weight_map"]) == set(tensors)
    for k, t in tensors.items():
        got = st_load(tmp_path / "sh" / index["weight_map"][k])[k]
        assert got.dtype == torch.bfloat16 and torch.equal(got, t.to(torch.bfloat16)), k


def _reference_checkpoint(root: Path, tied: bool):
    """A reference `save_llama_as_hf` directory, and the same tensors
    re-written as two index-sharded files. Returns (cfgs, tree, dirs)."""
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, tie_embeddings=tied)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, tie_embeddings=tied)
    params = jl.init_params(jcfg, jax.random.PRNGKey(0))
    single = root / "single"
    jload.save_llama_as_hf(params, jcfg, str(single))
    tensors = np_load_file(single / "model.safetensors")
    names = sorted(tensors)
    sharded = root / "sharded"
    sharded.mkdir()
    weight_map = {}
    for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        fn = f"model-{i + 1:05d}-of-00002.safetensors"
        np_save_file({k: tensors[k] for k in part}, sharded / fn)
        weight_map.update({k: fn for k in part})
    (sharded / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": 0}, "weight_map": weight_map}))
    return (jcfg, tcfg), params, {"single": single, "sharded": sharded}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    return {tied: _reference_checkpoint(root / str(tied), tied) for tied in (False, True)}


def _assert_trees_equal(got, want):
    def leaves(tree):
        yield "embed", tree["embed"]
        yield "final_norm", tree["final_norm"]
        yield "lm_head", tree["lm_head"]
        for k, v in tree["layers"].items():
            yield k, v

    want_leaves = dict(leaves(want))
    for name, g in leaves(got):
        w = want_leaves[name]
        if w is None:
            assert g is None, name
        elif tq.is_quant(w):
            assert tq.is_quant(g) and g["q"].dtype == torch.int8 and g["s"].dtype == torch.float32
            torch.testing.assert_close(g["q"], w["q"], rtol=0, atol=0, msg=name)
            torch.testing.assert_close(g["s"], w["s"], rtol=0, atol=0, msg=name)
        else:
            assert g.dtype == w.dtype, name
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("layout", ["single", "sharded"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_load_llama_params_equals_the_reference_load(ckpts, layout, quantize, tied):
    (jcfg, tcfg), params, dirs = ckpts[tied]
    want = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                        jload.load_llama_params(str(dirs[layout]), jcfg, quantize=quantize),
                        is_leaf=lambda a: a is None)
    got = tload.load_llama_params(str(dirs[layout]), tcfg, quantize=quantize, device="cpu")
    _assert_trees_equal(got, params_from_jax(want, device="cpu"))
    if quantize:  # the int8 load equals quantize_tree of the saved weights
        tree = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
        if tied:
            tree["lm_head"] = None
        _assert_trees_equal(got, tq.quantize_tree(tree))
        assert got["embed"]["s"].shape == (tcfg.vocab_size, 1)


def test_port_export_round_trips_through_both_loaders(tmp_path):
    """The port's save_llama_as_hf: the reference's single f32 file (which
    the reference loads), and BF16 index-sharded shards, which load back
    bit for bit."""
    gen = torch.Generator().manual_seed(1)
    cfg16 = tl.LlamaConfig.tiny(tie_embeddings=True)
    params = tl.init_params(cfg16, gen, device="cpu")
    assert tload.save_llama_as_hf(params, cfg16, str(tmp_path / "f32")) == ["model.safetensors"]
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, tie_embeddings=True)
    ref = jload.load_llama_params(str(tmp_path / "f32"), jcfg)
    np.testing.assert_array_equal(np.asarray(ref["layers"]["wq"]),
                                  params["layers"]["wq"].float().numpy())
    names = tload.save_llama_as_hf(params, cfg16, str(tmp_path / "bf16"), dtype=torch.bfloat16,
                                   max_shard_bytes=200_000)
    assert sio.INDEX_NAME in names and len(names) >= 3
    back = tload.load_llama_params(str(tmp_path / "bf16"), cfg16, device="cpu")
    _assert_trees_equal(back, params)


def test_moe_checkpoints_are_refused(tmp_path):
    """The dense loader refuses an MoE checkpoint, and the MoE loader a
    dense model (tests/test_torch_moe_loader.py loads MoE checkpoints)."""
    np_save_file({"model.layers.0.block_sparse_moe.gate.weight": np.zeros((4, 8), np.float32)},
                 tmp_path / "model.safetensors")
    with pytest.raises(ValueError, match="an MoE checkpoint; load it with load_moe_params"):
        tload.load_llama_params(str(tmp_path), TCFG, device="cpu")
    with pytest.raises(ValueError, match="needs an MoeConfig"):
        tload.load_moe_params(str(tmp_path), TCFG, device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        tload.load_llama_params(str(tmp_path), TCFG, quantize="int4", device="cpu")


# ---------------------------------------------------------------------- #
# model resolution: local paths and the HF hub cache, offline
# ---------------------------------------------------------------------- #

@pytest.fixture()
def hub_cache(tmp_path, monkeypatch):
    """A fake hub cache holding org/cached at main and at a tag; the port
    reads HF_HUB_CACHE, the reference's huggingface_hub its constant."""
    import huggingface_hub.constants as hc

    cache = tmp_path / "hub"
    repo = cache / "models--org--cached"
    for rev, commit in (("main", "a" * 40), ("v1", "b" * 40)):
        (repo / "snapshots" / commit).mkdir(parents=True)
        (repo / "snapshots" / commit / "config.json").write_text("{}")
        (repo / "refs").mkdir(exist_ok=True)
        (repo / "refs" / rev).write_text(commit)
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(hc, "HF_HUB_CACHE", str(cache))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.delenv("DYN_HF_ALLOW_DOWNLOAD", raising=False)
    return cache


@pytest.mark.parametrize("revision", [None, "v1", "b" * 40])
def test_resolve_model_path_reads_the_hub_cache_as_the_reference(hub_cache, revision):
    got = tload.resolve_model_path("org/cached", revision=revision)
    assert Path(got) == Path(jload.resolve_model_path("org/cached", revision=revision))
    assert Path(got).parent.parent.name == "models--org--cached"
    local = hub_cache.parent / "local_dir"
    local.mkdir()
    assert tload.resolve_model_path(str(local)) == jload.resolve_model_path(str(local)) == str(local)


def test_resolve_model_path_refusals(hub_cache, monkeypatch):
    for resolve in (tload.resolve_model_path, jload.resolve_model_path):
        with pytest.raises(FileNotFoundError, match="not an HF repo id"):
            resolve("/no/such/dir")
        with pytest.raises(FileNotFoundError, match="not in the HF cache"):
            resolve("org/uncached")
    with pytest.raises(UnsupportedConfigError, match="does not download"):
        tload.resolve_model_path("org/uncached", allow_download=True)
    monkeypatch.setenv("DYN_HF_ALLOW_DOWNLOAD", "1")
    with pytest.raises(UnsupportedConfigError, match="does not download"):
        tload.resolve_model_path("org/uncached")
    # a cached repo still resolves with downloads allowed: nothing to fetch
    assert Path(tload.resolve_model_path("org/cached")).name == "a" * 40
    with pytest.raises(UnsupportedConfigError, match="does not download"):
        tload.load_llama_params("org/uncached", TCFG, device="cpu")
    monkeypatch.delenv("DYN_HF_ALLOW_DOWNLOAD")
    with pytest.raises(FileNotFoundError, match="not in the HF cache"):
        tload.load_llama_params("org/uncached", TCFG, device="cpu")


# ---------------------------------------------------------------------- #
# the second oracle: transformers' own Llama
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_hf_transformers_checkpoint_prefill_logits_agree(tmp_path, tied):
    from transformers import LlamaConfig as HfLlamaConfig
    from transformers import LlamaForCausalLM

    torch.manual_seed(7)
    hf_cfg = HfLlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=tied,
        torch_dtype=torch.float32,
    )
    model = LlamaForCausalLM(hf_cfg).eval()
    model.save_pretrained(tmp_path, safe_serialization=True)
    prompts = [[7, 42, 101, 9, 250, 33, 17, 5, 300, 12, 8], [3, 99, 4]]
    with torch.no_grad():
        want = [model(torch.tensor([p])).logits[0, -1] for p in prompts]

    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, rope_theta=10000.0, tie_embeddings=tied)
    params = tload.load_llama_params(str(tmp_path), cfg, device="cpu")
    assert (params["lm_head"] is None) == tied
    ps, T, P = 8, 16, 4
    toks = np.zeros((2, T), np.int32)
    pos = np.full((2, T), P * ps - 1, np.int32)
    for b, p in enumerate(prompts):
        toks[b, : len(p)], pos[b, : len(p)] = p, np.arange(len(p))
    tables = np.zeros((2, P), np.int32)
    tables[:, :2] = [[1, 2], [3, 4]]
    kv = [torch.zeros(cfg.num_layers, 6, ps, cfg.num_kv_heads, cfg.head_dim) for _ in range(2)]
    logits, _, _ = tl.prefill_forward_batched(
        params, cfg, torch.from_numpy(toks), torch.from_numpy(pos), *kv,
        torch.from_numpy(tables), torch.zeros(2, dtype=torch.int32),
        torch.tensor([len(p) - 1 for p in prompts], dtype=torch.int32))
    torch.testing.assert_close(logits, torch.stack(want), rtol=2e-3, atol=2e-3)
    assert [int(x) for x in logits.argmax(-1)] == [int(w.argmax()) for w in want]
