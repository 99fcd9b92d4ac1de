"""Multimodal E/P/D on the port (llm/multimodal.py, llm/image_io.py, the
engine's prefill splice, the encode worker), against the JAX package, on
the CPU.

* The hop's pure functions (`part_content_key`, `MockVisionEncoder`,
  `placeholder_tokens`, `splice_placeholders`, `encode_parts`) equal the
  reference's; `ViTEncoder._pixels` is held to the reference's PIL path on
  PNGs of every colour type, resized and not, within one grey level
  before normalising; JPEG, interlaced and 16-bit PNGs are refused by name.
* `prefill_forward_batched` with `emb_override` / `emb_mask` against the
  reference's, in f32 over fp, int8 and int4 KV pools, for `tiny` and
  `tiny-moe` (2e-3 on logits and written pages).
* Greedy streams of `TorchEngine(device="cpu")` token-identical to
  `JaxEngine`'s on one staggered trace of image and text requests (mock
  embeddings and ViT-tiny embeddings, each engine's own encoder on the
  same weights carried across by `vit_params_from_jax`), in scatter and
  local pool modes with mixed dispatch on: an image that straddles a
  prefill chunk boundary, prefix-cache hits that end inside an image, and
  image requests in flight beside text ones.
* The reference's error items for un-encoded parts and wrong-width
  embeddings, and its refusals of image parts beside a LoRA adapter or
  guided decoding; `begin_streamed_pull` declines an image request and a
  disaggregated pair of port engines serves it equal to the aggregated
  stream (a dead prefill side included); `EncodeOperator`'s re-entry skip
  and retry (the reference's `tests/test_multimodal.py:244-308`).
* End to end: the reference frontend with `--encoder`, a port encode
  worker (`--encoder vit --device cpu`) and a port worker stream a chat
  completion with an image part.

Weights are drawn at std 0.15, as in `test_torch_engine.py`, so an f32
rounding difference between the frameworks cannot flip an argmax.
"""

import asyncio
import base64
import dataclasses
import io
import signal
import time
import zlib

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.llm import multimodal as jmm
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import moe as jmoe
from dynamo_tpu.models import vit as jvit
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm import image_io
from dynamo_tpu_torch.llm import multimodal as tmm
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import moe as tmoe
from dynamo_tpu_torch.models import vit as tvit
from dynamo_tpu_torch.models.convert import params_from_jax, vit_params_from_jax
from dynamo_tpu_torch.models.lora import init_adapter
from dynamo_tpu_torch.runtime import StreamLost
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.worker.disagg_handler import maybe_remote_prefill

from .test_torch_disagg import EngineClient, collect_handled, port_router
from .test_torch_engine import numpy_params
from .test_torch_moe import _pool, _store_np, numpy_params as moe_numpy_params
from .test_torch_llama import _prefill_inputs, _real_mask_pages
from .utils import ManagedProcess, free_port

TOL = dict(rtol=2e-3, atol=2e-3)
KW = dict(model="tiny", max_num_seqs=4, page_size=8, num_pages=64, max_model_len=128,
          prefill_buckets=(16, 32), max_prefill_chunk=32, decode_block_steps=4)
MOCK_TOKENS = 12  # a mock part's rows: 26 text tokens + 12 straddle the 32-token chunk
KW_HIDDEN = 64  # tiny's hidden width: the embeddings' width
LIMIT = 60  # seconds a test's coroutine may take
TEST_LIMIT = 90  # seconds any test may take (the end-to-end one starts processes)


@pytest.fixture(autouse=True)
def time_limit():
    """Every test fails, instead of hanging, past TEST_LIMIT seconds."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {TEST_LIMIT} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


# --------------------------------------------------------------------- #
# the hop's functions and the image decoder
# --------------------------------------------------------------------- #

PARTS = [{"type": "image_url", "url": "http://x/cat.png"},
         {"type": "image_url", "url": "data:image/png;base64,AAAA"},
         {"type": "image", "data": "QUJD"}, {"type": "input_audio", "input_audio": "x"}]


def test_hop_functions_equal_the_reference():
    for p in PARTS:
        assert tmm.part_content_key(p) == jmm.part_content_key(p)
        for n, vocab in ((4, 512), (17, 128256), (3, 3)):
            assert tmm.placeholder_tokens(p, n, vocab) == jmm.placeholder_tokens(p, n, vocab)
        np.testing.assert_array_equal(tmm.MockVisionEncoder(64, 5).encode(p),
                                      jmm.MockVisionEncoder(64, 5).encode(p))
    assert tmm.splice_placeholders([10, 11, 12], PARTS, 4, 512) == \
        jmm.splice_placeholders([10, 11, 12], PARTS, 4, 512)
    enc_t, enc_j = tmm.MockVisionEncoder(16, 3), jmm.MockVisionEncoder(16, 3)
    assert tmm.encode_parts(PARTS[:2], enc_t) == jmm.encode_parts(PARTS[:2], enc_j)
    assert tmm.DEFAULT_MM_TOKENS == jmm.DEFAULT_MM_TOKENS


def _smooth(h, w, channels=3):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([127 + 120 * np.sin(x / 7.0 + c) * np.cos(y / 9.0) for c in range(channels)],
                    -1).astype(np.uint8)


def _pil_png(kind: str, h: int, w: int) -> bytes:
    """PIL writes PNGs of each colour type (its own filter choice per row)."""
    from PIL import Image

    rng = np.random.RandomState(KINDS.index(kind))
    img = {
        "rgb": lambda: Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)),
        "rgb_smooth": lambda: Image.fromarray(_smooth(h, w)),
        "rgba": lambda: Image.fromarray(rng.randint(0, 256, (h, w, 4), np.uint8), "RGBA"),
        "grey": lambda: Image.fromarray(_smooth(h, w, 1)[..., 0], "L"),
        "grey_alpha": lambda: Image.fromarray(rng.randint(0, 256, (h, w, 2), np.uint8), "LA"),
        "grey_1bit": lambda: Image.fromarray(rng.randint(0, 2, (h, w)).astype(bool)),
        "palette": lambda: Image.fromarray(_smooth(h, w)).convert("P"),
        "palette_4bit": lambda: Image.fromarray(_smooth(h, w)).quantize(colors=12),
    }[kind]()
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


KINDS = ["rgb", "rgb_smooth", "rgba", "grey", "grey_alpha", "grey_1bit", "palette",
         "palette_4bit"]


@pytest.fixture(scope="module")
def encoders():
    """The reference's and the port's ViT-tiny encoders on one tree
    (projector to the tiny LLM's width 64)."""
    cfg = jvit.ViTConfig.tiny()
    jparams = jvit.init_params(cfg, jax.random.PRNGKey(5))
    tparams = vit_params_from_jax(jax.tree.map(np.asarray, jparams))
    return (jmm.ViTEncoder(config=cfg, params=jparams),
            tmm.ViTEncoder(config=tvit.ViTConfig.tiny(), params=tparams, device="cpu"))


@pytest.mark.parametrize("size", [(32, 32), (45, 61)], ids=["at_size", "resized"])
@pytest.mark.parametrize("kind", KINDS)
def test_pixels_match_the_reference_pil_path(encoders, kind, size):
    """Within one grey level of PIL's `convert("RGB").resize(BILINEAR)`
    before normalising; at the encoder's own size (no resize) equal."""
    ref, enc = encoders
    png = _pil_png(kind, *size)
    part = {"type": "image_url", "url": "data:image/png;base64," + base64.b64encode(png).decode()}
    got, want = enc._pixels(part), ref._pixels(part)
    assert got.shape == want.shape == (3, 32, 32) and got.dtype == np.float32
    levels = np.abs((got - want) * 0.5 * 255.0)
    assert levels.max() <= 1.0 + 1e-4, levels.max()
    if size == (32, 32):
        assert levels.max() < 1e-4
    # the decode alone is exact against PIL
    from PIL import Image

    np.testing.assert_array_equal(image_io.decode_png(png),
                                  np.asarray(Image.open(io.BytesIO(png)).convert("RGB")))


def _write_png(rgb: np.ndarray, filters=(0, 1, 2, 3, 4), interlace=0, depth=8) -> bytes:
    """A minimal PNG writer cycling the row filters (RGB, 8 or 16 bits)."""
    import struct

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    h, w, _ = rgb.shape
    data = rgb.astype(">u2") if depth == 16 else rgb.astype(np.uint8)
    raw = data.reshape(h, -1).view(np.uint8).astype(np.int32)
    bpp = 3 * depth // 8
    out, prior = bytearray(), np.zeros(raw.shape[1], np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        row = raw[y]
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if f == 4:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        else:
            pred = [np.zeros_like(row), left, prior, (left + prior) >> 1][f]
        out.append(f)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = row
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, interlace)
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (0, 1, 2), (3,), (4,), (0, 1, 2, 3, 4)])
def test_decoder_undoes_every_row_filter(filters):
    rgb = np.random.RandomState(len(filters)).randint(0, 256, (19, 23, 3), np.uint8)
    np.testing.assert_array_equal(image_io.decode_png(_write_png(rgb, filters)), rgb)


def test_other_formats_are_refused_by_name():
    from PIL import Image

    img = Image.fromarray(_smooth(16, 16))
    for fmt, name in (("JPEG", "JPEG"), ("GIF", "GIF"), ("BMP", "BMP"), ("WEBP", "WebP")):
        buf = io.BytesIO()
        img.save(buf, format=fmt)
        with pytest.raises(ValueError, match=f"image format {name} .*no image decoder"):
            image_io.load_rgb(buf.getvalue(), 32)
    rgb = _smooth(8, 8)
    with pytest.raises(ValueError, match="interlaced"):
        image_io.decode_png(_write_png(rgb, interlace=1))
    with pytest.raises(ValueError, match="bit depth 16"):
        image_io.decode_png(_write_png(rgb, depth=16))


@pytest.mark.parametrize("n", [15, 16, 3072])
def test_embedding_rows_cross_the_wire_as_msgpack(n):
    """The encode worker's reply (nested float lists) packs to msgpack's own
    bytes and back on the float-run path and beside it (shorter lists, a
    list with a non-float in it)."""
    import msgpack

    from dynamo_tpu_torch.runtime import msgpack_lite

    rows = np.random.RandomState(n).randn(3, n).astype(np.float32).tolist()
    for obj in ({"data": {"multimodal": [{"type": "image_url", "embedding": rows}],
                          "n_tokens": 3}},
                rows[0] + [7], [float("inf"), -0.0] * n, (0.5,) * n):
        raw = msgpack_lite.packb(obj)
        assert raw == msgpack.packb(obj, use_bin_type=True)
        want = msgpack.unpackb(raw, raw=False)
        assert msgpack_lite.unpackb(raw) == want


# --------------------------------------------------------------------- #
# the prefill splice in the forwards
# --------------------------------------------------------------------- #

def _splice_operands(B, T, H, seed=4):
    rng = np.random.RandomState(seed)
    emb = (rng.randn(B, T, H) * 0.3).astype(np.float32)
    mask = np.zeros((B, T), bool)
    mask[0, 2:9] = True  # inside a full chunk
    mask[1, 5:10] = True  # running into the padded tail (last real index 9)
    return emb, mask


def _dense_weights():
    tree = numpy_params()
    jparams = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), tree,
                           is_leaf=lambda a: a is None)
    return (jllama, jllama.LlamaConfig.tiny(dtype=jnp.float32), jparams,
            tllama, tllama.LlamaConfig.tiny(dtype=torch.float32),
            params_from_jax(tree, device="cpu"))


def _moe_weights():
    tree = moe_numpy_params()
    jparams = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), tree,
                           is_leaf=lambda a: a is None)
    jc = dataclasses.replace(jmoe.MoeConfig.tiny_moe(dtype=jnp.float32), capacity_factor=8.0)
    tc = dataclasses.replace(tmoe.MoeConfig.tiny_moe(dtype=torch.float32), capacity_factor=8.0)
    return jmoe, jc, jparams, tmoe, tc, params_from_jax(tree, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fmt", ["none", "int8", "int4"])
@pytest.mark.parametrize("family", ["tiny", "tiny-moe"])
def test_prefill_splice_matches_reference(family, fmt):
    jm, jc, jparams, tm, tc, tparams = _dense_weights() if family == "tiny" else _moe_weights()
    toks, pos, tables, ctx, last = _prefill_inputs()
    emb, mask = _splice_operands(*toks.shape, jc.hidden_size)
    rng = np.random.RandomState(10)
    (jk, tk), (jv, tv) = _pool(rng, fmt), _pool(rng, fmt)
    fwd = jax.jit(jm.prefill_forward_batched, static_argnums=1)
    jlog, jk2, jv2 = fwd(jparams, jc, *[jnp.asarray(a) for a in (toks, pos)], jk, jv,
                         *[jnp.asarray(a) for a in (tables, ctx, last)],
                         emb_override=jnp.asarray(emb), emb_mask=jnp.asarray(mask))
    tlog, _, _ = tm.prefill_forward_batched(
        tparams, tc, _t(toks), _t(pos), tk, tv, _t(tables), _t(ctx), _t(last),
        emb_override=_t(emb), emb_mask=_t(mask))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for got_store, want_store in ((tk, jk2), (tv, jv2)):
        for got, want in zip(_store_np(got_store), _store_np(want_store)):
            got, want = _real_mask_pages(got), _real_mask_pages(want)
            if got.dtype == np.int8:  # quantized rows may round one step apart
                assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, **TOL)
    # the splice is real compute, and an all-False mask is an exact no-op
    def port(**kw):
        rng = np.random.RandomState(10)
        (_, k), (_, v) = _pool(rng, fmt), _pool(rng, fmt)
        return tm.prefill_forward_batched(
            tparams, tc, _t(toks), _t(pos), k, v, _t(tables), _t(ctx), _t(last), **kw)[0]

    base = port()
    assert torch.equal(port(emb_override=_t(emb), emb_mask=_t(np.zeros_like(mask))), base)
    assert (tlog - base).abs().max() > 1e-3


# --------------------------------------------------------------------- #
# the engine against the JAX engine
# --------------------------------------------------------------------- #

def _png_url(seed: int, h: int, w: int) -> str:
    rgb = np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)
    return "data:image/png;base64," + base64.b64encode(_write_png(rgb)).decode()


# mock-encoded, and three PNGs at ViT-tiny's own 32 px: a resize differs
# from PIL's by up to one grey level by design (held above), and the
# engines are compared on equal pixels
CAT = {"type": "image_url", "url": "http://x/cat.png"}
VIT_X = {"type": "image_url", "url": _png_url(1, 32, 32)}
VIT_Y = {"type": "image_url", "url": _png_url(2, 32, 32)}
VIT_Z = {"type": "image_url", "url": _png_url(3, 32, 32)}


def trace_specs():
    """(request id, text tokens, parts, encoder kind, max tokens). `cat`:
    26 text tokens + 12 mock rows straddle the 32-token chunk; `cat_again`
    repeats it (its prefix hit, 4 pages, ends inside the image at 32);
    `vit_xz` shares `vit_xy`'s text and first image (its hit, 2 pages, ends
    inside image X at 16); text requests arrive between them."""
    rng = np.random.RandomState(21)
    text = lambda n: rng.randint(3, 500, size=n).tolist()  # noqa: E731
    t_cat, t_vit = text(26), text(6)
    return [
        ("text0", text(20), [], None, 12),
        ("cat", t_cat, [CAT], "mock", 12),
        ("vit_xy", t_vit, [VIT_X, VIT_Y], "vit", 12),
        ("cat_again", t_cat, [CAT], "mock", 12),
        ("text4", text(30), [], None, 10),
        ("vit_xz", t_vit, [VIT_X, VIT_Z], "vit", 12),
    ]


def build_requests(mm, vit_encoder) -> list:
    """The trace's requests, encoded by one package's encoders (`mm`: that
    package's multimodal module)."""
    mock = mm.MockVisionEncoder(KW_HIDDEN, n_tokens=MOCK_TOKENS)
    reqs = []
    for rid, text, parts, kind, max_tokens in trace_specs():
        req = {"request_id": rid, "token_ids": list(text),
               "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
               "sampling_options": {"temperature": 0.0}}
        if parts:
            enc = mock if kind == "mock" else vit_encoder
            encoded = mm.encode_parts([dict(p) for p in parts], enc)
            req["token_ids"], req["multimodal"] = mm.splice_placeholders(
                text, encoded, enc.n_tokens, 512)
        reqs.append(req)
    return reqs



async def drive(engine, reqs, ctx_cls):
    """Staggered: request i+1 arrives once request i has its first token."""
    results = {}

    async def one(req, started):
        toks = []
        async for item in engine.generate(req, ctx_cls()):
            assert item.get("event") != "error", item
            data = item.get("data")
            if data:
                toks.extend(data["token_ids"])
                started.set()
        started.set()
        results[req["request_id"]] = toks

    tasks = []
    for req in reqs:
        started = asyncio.Event()
        tasks.append(asyncio.create_task(one(req, started)))
        await started.wait()
    await asyncio.gather(*tasks)
    stats = engine.stats()
    await engine.close()
    return results, stats


@pytest.fixture(scope="module")
def weights():
    return numpy_params()


@pytest.fixture(scope="module")
def reference(weights, encoders):
    params = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), weights,
                          is_leaf=lambda a: a is None)
    engine = JaxEngine(JaxEngineConfig(**KW), model_config=jllama.LlamaConfig.tiny(
        dtype=jnp.float32), params=params)
    return run(drive(engine, build_requests(jmm, encoders[0]), JaxContext))


def torch_engine(weights, **kw) -> TorchEngine:
    return TorchEngine(EngineConfig(**KW, **kw),
                       model_config=tllama.LlamaConfig.tiny(dtype=torch.float32),
                       params=params_from_jax(weights, device="cpu"), device="cpu")


@pytest.mark.parametrize("mode", ["scatter", "local"])
def test_image_streams_token_identical_to_jax_engine(weights, encoders, reference, mode):
    engine = torch_engine(weights, decode_pool_mode=mode, mixed_dispatch=True)
    got, stats = run(drive(engine, build_requests(tmm, encoders[1]), Context))
    want, ref_stats = reference
    for rid, *_ in trace_specs():
        assert len(want[rid]) > 0 and got[rid] == want[rid], rid
    # images steer generation: the same text with another second image
    # streams otherwise, the repeat streams the same
    assert got["cat_again"] == got["cat"] and got["vit_xz"] != got["vit_xy"]
    # the repeats hit the prefix cache inside their images (4 + 2 pages)
    assert stats["kv_prefix_hit_blocks_total"] == ref_stats["kv_prefix_hit_blocks_total"] >= 6
    assert stats["mixed_steps"] >= 1  # text and images were in flight together


# --------------------------------------------------------------------- #
# refusals, disaggregation, the encode hop
# --------------------------------------------------------------------- #

BAD_PARTS = {
    "unencoded": [dict(CAT)],
    "wrong_width": [{"type": "image_url", "url": "x", "position": 4,
                     "embedding": [[0.0] * 32] * 4}],
    "not_numeric": [{"type": "image_url", "url": "x", "position": 4,
                     "embedding": [[0.0, "a"]] * 4}],
}


@pytest.mark.parametrize("case", list(BAD_PARTS))
def test_bad_parts_get_the_reference_error_item(weights, case):
    """The request gets one error item with the reference's text; the
    engine serves text afterwards."""
    async def items(engine, ctx_cls):
        req = {"token_ids": list(range(5, 13)), "multimodal": BAD_PARTS[case],
               "stop_conditions": {"max_tokens": 4}}
        out = [item async for item in engine.generate(req, ctx_cls())]
        ok = [item async for item in engine.generate(
            {"token_ids": [5, 6, 7], "stop_conditions": {"max_tokens": 2}}, ctx_cls())]
        await engine.close()
        return out, ok

    params = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), weights,
                          is_leaf=lambda a: a is None)
    jeng = JaxEngine(JaxEngineConfig(**KW), model_config=jllama.LlamaConfig.tiny(
        dtype=jnp.float32), params=params)
    want, _ = run(items(jeng, JaxContext))
    got, ok = run(items(torch_engine(weights), Context))
    assert len(got) == 1 and got[0]["event"] == "error" and got == want
    assert any((i.get("data") or {}).get("token_ids") for i in ok)


def _encoded_request(rid="img", **kw) -> dict:
    [part] = tmm.encode_parts([dict(CAT)], tmm.MockVisionEncoder(KW_HIDDEN, MOCK_TOKENS))
    ids, stamped = tmm.splice_placeholders(list(range(5, 31)), [part], MOCK_TOKENS, 512)
    return {"request_id": rid, "token_ids": ids, "multimodal": stamped,
            "stop_conditions": {"max_tokens": 8, "ignore_eos": True},
            "sampling_options": {"temperature": 0.0}, **kw}


def test_lora_and_guided_with_images_are_refused(weights):
    async def main():
        engine = torch_engine(weights)
        engine.register_adapters([init_adapter(engine.model_config, "ad",
                                               torch.Generator().manual_seed(1))])
        out = {}
        for key, extra in (("lora", {"lora_name": "ad"}),
                           ("guided", {"guided": {"kind": "regex", "regex": "[ab]*"}}),
                           ("unknown_lora", {"lora_name": "nope"})):
            out[key] = [i async for i in engine.generate(_encoded_request(**extra), Context())]
        pins = engine._lora_pool.pinned()
        await engine.close()
        return out, pins

    out, pins = run(main())
    msg = {k: [i["comment"][0] for i in v if i.get("event") == "error"] for k, v in out.items()}
    assert msg["lora"] == ["LoRA with multimodal content parts is not supported yet"]
    assert msg["guided"] == ["guided decoding cannot be combined with multimodal parts"]
    assert msg["unknown_lora"][0].startswith("unknown LoRA adapter 'nope'")  # the reference's order
    assert pins == 0  # no refusal leaks an adapter pin


def test_disagg_pair_serves_an_image_request_as_aggregated(weights):
    """`begin_streamed_pull` declines an image request, so the decode
    side's handler takes the serial handoff: the port prefill engine splices,
    the decode engine pulls, and the stream equals the aggregated one; with
    the prefill side dead the local fallback prefill splices too."""
    from dynamo_tpu_torch.llm import kv_transfer as tkt

    async def main():
        agg = torch_engine(weights)
        want = [t for i in [x async for x in agg.generate(_encoded_request(), Context())]
                for t in (i.get("data") or {}).get("token_ids") or []]
        await agg.close()
        pre, dec = torch_engine(weights, role="prefill"), torch_engine(weights)
        plane = tkt.KvDataPlaneServer(host="127.0.0.1")
        await plane.start()
        pre.data_plane = plane
        try:
            assert dec.begin_streamed_pull(_encoded_request(), Context(),
                                           {"n_tokens": 38, "transfer_id": "t"}) is None
            req = _encoded_request(annotations=["remote_prefill"])
            remote = await collect_handled(maybe_remote_prefill(
                dec, EngineClient(pre, Context), port_router(), req, Context()))
            dec.clear_kv_blocks()
            local = await collect_handled(maybe_remote_prefill(
                dec, EngineClient(pre, Context, dead=True), port_router(),
                _encoded_request(rid="img2", annotations=["remote_prefill"]), Context()))
            return want, remote, local, dec.stats()
        finally:
            for x in (pre, dec, plane):
                await x.close()

    want, remote, local, stats = run(main())
    assert len(want) == 8
    assert remote == (want, True)
    assert local[0] == want
    assert stats["kv_pulls_completed"] == 1 and stats["disagg_streamed_handoffs"] == 0


@pytest.mark.parametrize("cut", [1, 5])
def test_migrated_image_stream_resumes_with_the_splice(weights, cut):
    """A stream cut after `cut` tokens is retried by the port's Migration
    with its stamped parts (the encode hop passes the retry through), on
    an engine whose prefix cache holds the prompt's first four pages: the
    tail past them reaches into the image after 1 token (so it is
    prefilled with the splice, not recomputed decode-shaped) and past it
    after 5 (decode-shaped). Both equal the uninterrupted stream."""
    from dynamo_tpu_torch.llm.migration import Migration
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest

    from .test_torch_migration import _Cut, _tokens

    async def main():
        engine = torch_engine(weights)
        try:
            whole = _tokens([i async for i in engine.generate(_encoded_request(), Context())])
            replays = engine.stats()["dev_time"].get("replay", {}).get("count", 0)
            link = _Cut(engine, cut)
            got = _tokens([a async for a in Migration(link, migration_limit=2).generate(
                PreprocessedRequest.from_dict(_encoded_request()), Context())])
            stats = engine.stats()
            return whole, got, link.requests, replays, stats
        finally:
            await engine.close()

    whole, got, requests, replays, stats = run(main())
    assert len(whole) == 8 and got == whole
    retry = requests[1]
    assert retry["multimodal"] == _encoded_request()["multimodal"]
    assert retry["token_ids"] == _encoded_request()["token_ids"] + whole[:cut]
    assert run(tmm.EncodeOperator(None, 512).forward(dict(retry), None)) == retry
    # 26 text tokens + 12 image rows (26-37): the retry finds pages up to
    # 32 (cut 1) or 40 (cut 5) cached, so its tail starts inside the image
    # (prefilled) or past it (one decode-shaped dispatch)
    tail_replayed = stats["dev_time"].get("replay", {}).get("count", 0) - replays
    assert stats["migrations_resumed"] == 1 and tail_replayed == {1: 0, 5: 1}[cut]


def test_encode_operator_reentry_skips_encode():
    """A migrated or disaggregated re-entry carries stamped parts: the hop
    passes it through untouched."""
    class _Router:
        called = 0

        async def generate(self, req, ctx):
            self.called += 1
            raise AssertionError("must not call the encode worker")

    router = _Router()
    op = tmm.EncodeOperator(router, vocab_size=512)
    stamped = {"type": "image_url", "url": "x", "position": 8, "n_tokens": 4,
               "embedding": [[0.0] * 64] * 4}
    req = {"token_ids": list(range(12)), "multimodal": [stamped]}
    out = run(op.forward(dict(req), None))
    assert out["token_ids"] == req["token_ids"] and out["multimodal"] == [stamped]
    assert router.called == 0
    assert op.name == "Encode" and op.backward("s", req, None) == "s"
    assert op.around(None, req, None) is None


def test_encode_operator_retries_transient_stream_loss():
    enc = tmm.MockVisionEncoder(hidden_size=16, n_tokens=2)
    part = {"type": "image_url", "url": "r"}

    class _FlakyRouter:
        calls = 0

        async def generate(self, req, ctx):
            self.calls += 1
            if self.calls == 1:
                raise StreamLost("no instances for dynamo.encoder.encode")

            async def stream():
                yield {"data": {"multimodal": tmm.encode_parts([part], enc), "n_tokens": 2}}

            return stream()

    router = _FlakyRouter()
    op = tmm.EncodeOperator(router, vocab_size=512, retry_delay_s=0.05)
    out = run(op.forward({"token_ids": [5, 6, 7], "multimodal": [part]}, None))
    assert router.calls == 2
    assert out["multimodal"][0]["embedding"] is not None
    assert out["token_ids"] == [5, 6, 7] + tmm.placeholder_tokens(part, 2, 512)

    class _DeadRouter:
        async def generate(self, req, ctx):
            raise StreamLost("gone")

    op2 = tmm.EncodeOperator(_DeadRouter(), vocab_size=512, max_attempts=2, retry_delay_s=0.05)
    with pytest.raises(StreamLost):
        run(op2.forward({"token_ids": [1], "multimodal": [part]}, None))


def test_epd_serving_e2e(tmp_path):
    """The reference frontend with `--encoder`, a port encode worker (the
    ViT, tiny, on the CPU) and a port worker: an image_url chat request
    flows E -> P -> D and streams a completion; the same image repeats its
    text, another image still serves."""
    http_port = free_port()
    disc = f"tcp://127.0.0.1:{free_port()}"
    fe = ManagedProcess(
        ["-m", "dynamo_tpu.frontend", "--http-port", str(http_port), "--embed-discovery",
         "--discovery", disc, "--encoder", "dynamo/encoder/encode"], name="mm_fe",
    ).start(str(tmp_path / "fe.log"))
    procs = [fe]
    try:
        fe.wait_port(http_port)
        procs.append(ManagedProcess(
            ["-m", "dynamo_tpu_torch.encode_worker", "--discovery", disc, "--model", "tiny",
             "--encoder", "vit", "--vit-size", "tiny", "--device", "cpu"], name="mm_encoder",
        ).start(str(tmp_path / "encoder.log")))
        worker = ManagedProcess(
            ["-m", "dynamo_tpu_torch.worker", "--model", "tiny", "--model-name", "tiny-mm",
             "--device", "cpu", "--discovery", disc, "--page-size", "8", "--num-pages", "64",
             "--max-num-seqs", "4", "--max-model-len", "128", "--context-length", "128"],
            name="mm_worker",
        ).start(str(tmp_path / "worker.log"))
        procs.append(worker)
        base = f"http://127.0.0.1:{http_port}"
        deadline = time.time() + 45
        with httpx.Client(timeout=30.0) as client:
            while not client.get(f"{base}/v1/models").json()["data"]:
                if worker.proc.poll() is not None:
                    raise RuntimeError((tmp_path / "worker.log").read_text()[-2000:])
                assert time.time() < deadline, "the port worker never registered"
                time.sleep(0.3)
            payload = {
                "model": "tiny-mm", "max_tokens": 8, "temperature": 0.0,
                "messages": [{"role": "user", "content": [
                    {"type": "text", "text": "describe"},
                    {"type": "image_url", "image_url": {"url": VIT_X["url"]}}]}],
            }
            replies = []
            for url in (VIT_X["url"], VIT_X["url"], VIT_Y["url"]):
                payload["messages"][0]["content"][1]["image_url"]["url"] = url
                r = client.post(f"{base}/v1/chat/completions", json=payload, timeout=60.0)
                assert r.status_code == 200, r.text
                replies.append(r.json())
        assert replies[0]["choices"][0]["message"]["content"] == \
            replies[1]["choices"][0]["message"]["content"]
        assert all(r["usage"]["completion_tokens"] == 8 for r in replies)
        # prompt = the rendered text + the 16 placeholder rows of a ViT-tiny part
        assert replies[0]["usage"]["prompt_tokens"] > 16
        assert "encoded 1 part(s)" in (tmp_path / "encoder.log").read_text()
    finally:
        for p in reversed(procs):
            p.stop()
