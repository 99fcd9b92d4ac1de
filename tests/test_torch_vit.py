"""The port's ViT encoder (`dynamo_tpu_torch/models/vit.py`) against the JAX
reference and HF `transformers.ViTModel`, on the CPU.

The same numpy weights (the reference's `init_params` tree carried across
by `vit_params_from_jax`) and the same pixels, made from a seed, go through
`dynamo_tpu.models.vit` and the port; a random-config `ViTModel`'s state
dict goes through both packages' `params_from_hf_state`. Tolerance: atol
2e-4, rtol 2e-3 (the reference's own, tests/test_vit.py). HF exports
written with `save_pretrained` load equal through both `load_vit_params`.
"""

import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.llm.multimodal import ViTEncoder as JaxViTEncoder
from dynamo_tpu.models import vit as jv
from dynamo_tpu_torch.llm.multimodal import ViTEncoder
from dynamo_tpu_torch.models import vit as tv
from dynamo_tpu_torch.models.convert import vit_params_from_jax

TOL = dict(atol=2e-4, rtol=2e-3)
JCFG = jv.ViTConfig.tiny()
TCFG = tv.ViTConfig.tiny()


@pytest.fixture(scope="module")
def weights():
    """(the reference's tree, the same as numpy, the port's tree)."""
    jparams = jv.init_params(JCFG, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, tree, vit_params_from_jax(tree)


def _pixels(seed=5, B=2, cfg=TCFG):
    return np.random.RandomState(seed).randn(
        B, cfg.num_channels, cfg.image_size, cfg.image_size).astype(np.float32)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def _assert_trees(got, want, skip=(), **tol):
    """Port tree (tensors) against a reference tree (arrays), leaf by leaf."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            if k not in skip:
                _assert_trees(got[k], want[k], **tol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees(g, w, **tol)
    else:
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or dict(rtol=0, atol=0)))


@pytest.mark.parametrize("name", ["base", "tiny"])
def test_config_matches_reference(name):
    j = jv.ViTConfig() if name == "base" else jv.ViTConfig.tiny()
    t = tv.ViTConfig() if name == "base" else tv.ViTConfig.tiny()
    for f in ("image_size", "patch_size", "num_channels", "hidden_size", "num_layers",
              "num_heads", "intermediate_size", "layer_norm_eps", "out_hidden",
              "n_patches", "head_dim"):
        assert getattr(j, f) == getattr(t, f), f
    assert t.dtype == torch.float32


def test_init_params_shapes_and_seed(weights):
    a = tv.init_params(TCFG, torch.Generator().manual_seed(1))
    b = tv.init_params(TCFG, torch.Generator().manual_seed(1), device="cpu")
    _assert_trees(a, _np_tree(b))  # the same seed draws the same tree
    ref = weights[1]
    shapes = jax.tree.map(np.shape, ref)
    assert jax.tree.map(lambda t: tuple(t.shape), a) == shapes


@pytest.mark.parametrize("fn", ["forward", "encode_tokens"])
def test_forward_matches_reference(weights, fn):
    jparams, _, tparams = weights
    px = _pixels()
    want = np.asarray(getattr(jv, fn)(jparams, JCFG, jnp.asarray(px)))
    got = getattr(tv, fn)(tparams, TCFG, torch.from_numpy(px))
    assert got.dtype == torch.float32
    shape = (2, TCFG.n_patches + 1, TCFG.hidden_size) if fn == "forward" \
        else (2, TCFG.n_patches, TCFG.out_hidden)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _hf_model(seed=11):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.ViTConfig(
        image_size=TCFG.image_size, patch_size=TCFG.patch_size,
        num_channels=TCFG.num_channels, hidden_size=TCFG.hidden_size,
        num_hidden_layers=TCFG.num_layers, num_attention_heads=TCFG.num_heads,
        intermediate_size=TCFG.intermediate_size, layer_norm_eps=TCFG.layer_norm_eps,
        hidden_act="gelu")
    torch.manual_seed(seed)
    return transformers, hf_cfg, transformers.ViTModel(hf_cfg, add_pooling_layer=False).eval()


def test_forward_matches_hf_vit_model():
    _, _, hf = _hf_model()
    state = hf.state_dict()
    px = _pixels(seed=7)
    with torch.no_grad():
        want = hf(torch.from_numpy(px)).last_hidden_state.numpy()
    got = tv.forward(tv.params_from_hf_state(state, TCFG), TCFG, torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the reference maps the same state onto the same tree (projector aside)
    jparams = jv.params_from_hf_state(state, JCFG)
    _assert_trees(tv.params_from_hf_state(state, TCFG), _np_tree(jparams), skip=("proj",))


@pytest.mark.parametrize("export", ["safetensors", "bin", "classifier", "with_proj"])
def test_load_vit_params_matches_reference(tmp_path, export):
    """`save_pretrained` exports: safetensors, a pytorch_model.bin, a
    `ViTForImageClassification` ("vit." prefix), and one that carries a
    projector. Both loaders give the same tree; a missing projector is the
    port's own PROJ_SEED draw."""
    transformers, hf_cfg, hf = _hf_model(seed=13)
    if export == "classifier":
        torch.manual_seed(13)
        hf = transformers.ViTForImageClassification(hf_cfg).eval()
    hf.save_pretrained(tmp_path, safe_serialization=export != "bin")
    if export == "with_proj":
        from safetensors.torch import load_file, save_file

        st = load_file(str(tmp_path / "model.safetensors"))
        g = torch.Generator().manual_seed(21)
        st.update({"proj.w1": torch.randn(TCFG.hidden_size, TCFG.out_hidden, generator=g),
                   "proj.b1": torch.randn(TCFG.out_hidden, generator=g),
                   "proj.w2": torch.randn(TCFG.out_hidden, TCFG.out_hidden, generator=g),
                   "proj.b2": torch.randn(TCFG.out_hidden, generator=g)})
        save_file(st, str(tmp_path / "model.safetensors"))
    want = _np_tree(jv.load_vit_params(str(tmp_path), JCFG))
    got = tv.load_vit_params(str(tmp_path), TCFG)
    if export == "with_proj":
        _assert_trees(got, want)
    else:
        _assert_trees(got, want, skip=("proj",))
        drawn = tv._init_proj(TCFG, torch.Generator().manual_seed(tv.PROJ_SEED))
        _assert_trees(got["proj"], _np_tree(drawn))
    px = _pixels(seed=9, B=1)
    np.testing.assert_allclose(
        tv.forward(got, TCFG, torch.from_numpy(px)).numpy(),
        np.asarray(jv.forward(jv.load_vit_params(str(tmp_path), JCFG), JCFG, jnp.asarray(px))),
        **TOL)


def test_load_vit_params_without_weights_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no ViT weights"):
        tv.load_vit_params(str(tmp_path), TCFG)


def _png(seed: int, size: int = 48) -> bytes:
    from PIL import Image

    rgb = np.random.RandomState(seed).randint(0, 255, size=(size, size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    return buf.getvalue()


def test_vit_encoder_matches_reference_encoder(weights):
    """The two encoders on the same weights and the same PNG: data URL,
    inline base64, and raw pixels; a plain URL is refused."""
    jparams, tree, tparams = weights
    ref = JaxViTEncoder(config=JCFG, params=jparams)
    enc = ViTEncoder(config=TCFG, params=tparams, device="cpu")
    assert (enc.n_tokens, enc.hidden_size) == (ref.n_tokens, ref.hidden_size)
    png = _png(1, size=TCFG.image_size)  # no resize: both sides see equal pixels
    url = {"type": "image_url", "url": "data:image/png;base64," + base64.b64encode(png).decode()}
    e1 = enc.encode(url)
    assert e1.shape == (TCFG.n_patches, TCFG.out_hidden) and e1.dtype == np.float32
    np.testing.assert_array_equal(e1, enc.encode(url))  # deterministic
    inline = {"type": "image", "data": base64.b64encode(png).decode()}
    np.testing.assert_array_equal(e1, enc.encode(inline))
    other = {"type": "image_url",
             "url": "data:image/png;base64," + base64.b64encode(_png(2)).decode()}
    assert np.abs(e1 - enc.encode(other)).max() > 1e-4
    # the reference's PIL path against the port's decoder: the pixels are
    # equal at the encoder's own size (a resize differs by up to one grey
    # level: tests/test_torch_multimodal.py), so the outputs agree at TOL
    np.testing.assert_allclose(e1, ref.encode(url), **TOL)
    px = {"type": "image", "pixels": _pixels(seed=3, B=1)[0].tolist()}
    np.testing.assert_allclose(enc.encode(px), ref.encode(px), **TOL)
    with pytest.raises(ValueError, match="payload"):
        enc.encode({"type": "image_url", "url": "https://example.com/x.png"})
    with pytest.raises(ValueError, match="pixels shape"):
        enc.encode({"type": "image", "pixels": np.zeros((3, 8, 8)).tolist()})


def test_vit_encoder_defaults_and_device_rule():
    """Without params the weights are `init_params` from a CPU generator
    seeded with `seed`; `llm_hidden` sets the projector's width; cuda with
    no CUDA device raises."""
    enc = ViTEncoder(config=TCFG, llm_hidden=32, device="cpu")
    assert enc.config.out_hidden == 32 and enc.hidden_size == 32
    want = tv.init_params(enc.config, torch.Generator().manual_seed(0))
    _assert_trees(enc.params, _np_tree(want))
    assert ViTEncoder(llm_hidden=48, device="cpu").config == TCFG.__class__.tiny(out_hidden=48)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ViTEncoder(config=TCFG)
