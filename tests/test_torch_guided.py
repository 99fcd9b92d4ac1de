"""The port's guided decoding against the JAX reference, on the CPU.

  * `dynamo_tpu_torch/llm/guided.py` passes the reference's own unit tests
    (`tests/test_guided.py`: DFA acceptance, `schema_to_regex`, token FSM
    masks over the byte vocabulary, the request surface) with the port's
    module and tokenizer put in place of the reference's, and its regexes
    and masks equal the reference module's;
  * `sample(mask=)` and `unpack_mask` equal the reference's bit for bit;
  * guided engine streams (choice and json_schema, greedy and seeded, beside
    an unguided greedy stream, mixed dispatch on and off, and under spec on
    the fused path) equal the JAX engine's. The JAX engines run in a fresh
    interpreter: guided engine runs can crash XLA on the CPU when they share
    a process with the rest of the suite (see tests/test_guided.py);
  * a split-only spec engine refuses guided requests with a typed error.
"""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as jsamp
from dynamo_tpu.llm import guided as jg
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine, UnsupportedRequestError
from dynamo_tpu_torch.engine import sampling as tsamp
from dynamo_tpu_torch.llm import guided as tg
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.llm.tokenizers import ByteTokenizer
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime.engine import Context

from . import test_guided as ref_tests
from .test_torch_engine import numpy_params

REPO = Path(__file__).resolve().parents[1]

# the reference's unit tests of the module (everything before its
# preprocessor and engine tests)
REF_UNIT_TESTS = [
    "test_regex_dfa_basics", "test_regex_dfa_negated_and_other",
    "test_json_string_regex_rejects_raw_control_and_bad_escapes",
    "test_schema_to_regex_object", "test_schema_enum_const_union",
    "test_schema_optional_properties_and_unions",
    "test_schema_hostile_inputs_reject_cleanly", "test_free_json_value_bounded_depth",
    "test_token_fsm_masks_and_eos", "test_token_fsm_constrained_random_walk_yields_valid_json",
    "test_extract_guided_spec_surface",
]


@pytest.mark.parametrize("name", REF_UNIT_TESTS)
def test_reference_unit_tests_pass_on_the_port_module(name, monkeypatch):
    monkeypatch.setattr(ref_tests, "g", tg)
    monkeypatch.setattr(ref_tests, "ByteTokenizer", ByteTokenizer)
    getattr(ref_tests, name)()


SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "col": {"enum": ["red", "green"]}}}
SPECS = [
    {"kind": "choice", "choices": ["yes", "no", "maybe"]},
    {"kind": "regex", "regex": r"\d{1,3}(\.\d+)?"},
    {"kind": "json_schema", "schema": SCHEMA},
    {"kind": "json_schema", "schema": {"type": "array", "items": {"type": "integer"},
                                       "maxItems": 3}},
    {"kind": "json_object"},
]


@pytest.mark.parametrize("spec", SPECS, ids=[s["kind"] for s in SPECS])
def test_regex_and_token_masks_equal_the_reference(spec):
    """Same regex string, and the same admissible-token mask in every state
    of a constrained walk over the byte vocabulary (512 ids, the tiny
    model's)."""
    from dynamo_tpu.llm.tokenizers import ByteTokenizer as RefByteTokenizer

    assert tg.spec_to_regex(spec) == jg.spec_to_regex(spec)
    ours = tg.GuidedCompiler(ByteTokenizer(512)).compile(spec)
    theirs = jg.GuidedCompiler(RefByteTokenizer(512)).compile(spec)
    rng = np.random.RandomState(0)
    s_ours = s_theirs = ours.start_state
    for _ in range(40):
        m = ours.allowed(s_ours)
        np.testing.assert_array_equal(m, theirs.allowed(s_theirs))
        ids = np.nonzero(m)[0]
        tok = int(rng.choice(ids))
        if tok in ours.eos_ids:
            break
        s_ours, s_theirs = ours.advance(s_ours, tok), theirs.advance(s_theirs, tok)
        assert s_ours == s_theirs


def test_unpack_mask_and_masked_sample_bit_equal():
    B, V = 6, 517  # a vocabulary that is not a multiple of 8
    rng = np.random.RandomState(3)
    allowed = rng.rand(B, V) < 0.3
    allowed[:, 0] = True
    packed = np.packbits(allowed, axis=1)
    np.testing.assert_array_equal(
        tsamp.unpack_mask(torch.from_numpy(packed), V).numpy(),
        np.asarray(jsamp.unpack_mask(jnp.asarray(packed), V)))
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    temp = np.array([0, 0.7, 1.0, 1.3, 0.9, 0], np.float32)
    top_k = np.array([0, 0, 20, 0, 5, 0], np.int32)
    top_p = np.array([1, 1, 1, 0.8, 0.9, 1], np.float32)
    seeds = np.array([1, 2, 3, 4, 5, 6], np.uint32)
    positions = np.array([0, 9, 77, 3, 1000, 5], np.int32)
    jp = jsamp.SamplingParams(temperature=jnp.asarray(temp), top_k=jnp.asarray(top_k),
                              top_p=jnp.asarray(top_p), seed=jnp.asarray(seeds))
    tp = tsamp.SamplingParams(temperature=torch.from_numpy(temp),
                              top_k=torch.from_numpy(top_k), top_p=torch.from_numpy(top_p),
                              seed=torch.from_numpy(seeds.astype(np.int64)))
    mask_t = tsamp.unpack_mask(torch.from_numpy(packed), V)
    want = np.asarray(jsamp.sample(jnp.asarray(logits), jp, None,
                                   mask=jnp.asarray(allowed), positions=jnp.asarray(positions)))
    got = tsamp.sample(torch.from_numpy(logits), tp, torch.from_numpy(positions), mask=mask_t)
    np.testing.assert_array_equal(got.numpy(), want)
    assert allowed[np.arange(B), got.numpy()].all()
    # sample_lp: the masked draw, logprobs of the RAW (unmasked) logits
    jt, jlp, _, _ = jsamp.sample_lp(jnp.asarray(logits), jp, None, mask=jnp.asarray(allowed),
                                    positions=jnp.asarray(positions))
    tt, tlp, _, _ = tsamp.sample_lp(torch.from_numpy(logits), tp,
                                    torch.from_numpy(positions), mask=mask_t)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5)


# ---------------------------------------------------------------------- #
# engine streams
# ---------------------------------------------------------------------- #

ENGINE_KW = dict(model="tiny", max_num_seqs=4, page_size=8, num_pages=64, max_model_len=256,
                 prefill_buckets=(16, 32), max_prefill_chunk=32)
SPEC_KW = dict(spec_mode="ngram", spec_rounds=2, spec_draft_len=3, spec_ngram=2, spec_hist=64)
ARMS = {
    "mixed_on": dict(mixed_dispatch=True),
    "mixed_off": dict(mixed_dispatch=False),
    "spec_fused": dict(mixed_dispatch=True, **SPEC_KW),
}


def requests():
    """Guided choice and json_schema requests, greedy and seeded, and an
    unguided greedy stream batched with them (distinct first tokens: no
    shared prefix blocks)."""
    rng = np.random.RandomState(21)
    choice = {"kind": "choice", "choices": ["yes", "no", "maybe"]}
    schema = {"kind": "json_schema", "schema": SCHEMA}

    def req(i, guided, samp, n):
        return dict(token_ids=[40 + i] + rng.randint(5, 500, size=10 + 3 * i).tolist(),
                    request_id=f"g{i}", stop_conditions={"max_tokens": n},
                    sampling_options=samp, eos_token_ids=[ByteTokenizer.EOS], guided=guided)

    return [
        req(0, None, {"temperature": 0.0}, 20),
        req(1, choice, {"temperature": 0.0}, 16),
        req(2, choice, {"temperature": 1.0, "seed": 5}, 16),
        req(3, schema, {"temperature": 1.0, "seed": 3}, 120),
        req(4, schema, {"temperature": 0.0}, 120),
    ]


async def drive(engine, request_cls, context_cls):
    """The requests staggered by events (each arrives once the previous one
    has a token); returns {request_id: (tokens, finish_reason)} and the
    engine's stats."""
    out = {}

    async def one(spec, started):
        toks, finish = [], None
        async for item in engine.generate(request_cls(**spec).to_dict(), context_cls()):
            assert item.get("event") != "error", item
            data = item.get("data") or {}
            toks.extend(data.get("token_ids") or [])
            finish = data.get("finish_reason") or finish
            started.set()
        started.set()
        out[spec["request_id"]] = (toks, finish)

    tasks = []
    for spec in requests():
        started = asyncio.Event()
        tasks.append(asyncio.create_task(one(spec, started)))
        await started.wait()
    await asyncio.gather(*tasks)
    stats = engine.stats()
    await engine.close()
    return out, stats


def jax_streams() -> dict:
    """Every arm's streams on the JAX engine (run in a fresh interpreter)."""
    import jax
    import jax.numpy as jnp

    from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
    from dynamo_tpu.llm.protocols import PreprocessedRequest as JaxRequest
    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu.runtime.engine import Context as JaxContext

    params = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), numpy_params(),
                          is_leaf=lambda a: a is None)
    out = {}
    for arm, kw in ARMS.items():
        eng = JaxEngine(JaxEngineConfig(**ENGINE_KW, **kw),
                        model_config=jllama.LlamaConfig.tiny(dtype=jnp.float32), params=params)
        streams, _ = asyncio.run(drive(eng, JaxRequest, JaxContext))
        out[arm] = streams
    return out


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    code = ("import json; from tests.test_torch_guided import jax_streams; "
            "print('STREAMS=' + json.dumps(jax_streams()))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("STREAMS=")][-1]
    return {arm: {rid: (t, f) for rid, (t, f) in streams.items()}
            for arm, streams in json.loads(line[len("STREAMS="):]).items()}


def _torch_engine(**kw):
    return TorchEngine(EngineConfig(**ENGINE_KW, **kw),
                       model_config=tllama.LlamaConfig.tiny(dtype=torch.float32),
                       params=params_from_jax(numpy_params(), device="cpu"), device="cpu")


@pytest.mark.parametrize("arm", list(ARMS))
def test_guided_streams_equal_the_jax_engine(reference, arm):
    got, stats = asyncio.run(drive(_torch_engine(**ARMS[arm]), PreprocessedRequest, Context))
    assert got == reference[arm]
    tok = ByteTokenizer(512)
    for rid in ("g1", "g2"):
        assert tok.decode(got[rid][0]) in ("yes", "no", "maybe")
        assert got[rid][1] == "eos"
    for rid in ("g3", "g4"):
        obj = json.loads(tok.decode(got[rid][0]))
        assert set(obj) == {"ok", "col"} and isinstance(obj["ok"], bool)
        assert obj["col"] in ("red", "green")
    assert stats["guided_requests"] == 4
    assert stats["dev_time"]["block_guided"]["count"] > 0
    if arm != "mixed_off":
        assert stats["mixed_rows_guided"] > 0


@pytest.mark.parametrize("arm", ["mixed_off", "spec_fused"])
def test_warmup_drives_the_masked_paths_without_a_guided_compile(arm):
    """warmup's guided request takes the masked single-step decode on a
    fixed mask (the even token ids): no guided spec is compiled until a
    request brings one."""
    engine = _torch_engine(**ARMS[arm])
    guided_tokens = []
    advance = engine._advance_guided

    def spy(slot, token):
        if slot.guided_fsm is not None:
            guided_tokens.append(token)
        advance(slot, token)

    engine._advance_guided = spy

    async def run():
        try:
            assert await engine.warmup() > 0
            return engine.stats()
        finally:
            await engine.close()

    stats = asyncio.run(run())
    assert stats["guided_requests"] == 1
    assert stats["dev_time"]["block_guided"]["count"] > 0
    assert len(guided_tokens) == 3 and all(t % 2 == 0 for t in guided_tokens)
    assert engine._guided is None


def test_guided_refused_on_a_split_only_spec_engine():
    engine = _torch_engine(mixed_dispatch=False, **SPEC_KW)

    async def run():
        req = PreprocessedRequest(token_ids=[5, 9], guided={"kind": "regex", "regex": "a+"})
        try:
            with pytest.raises(UnsupportedRequestError, match="guided.*speculative"):
                async for _ in engine.generate(req.to_dict(), Context()):
                    pass
        finally:
            await engine.close()

    asyncio.run(run())


def test_guided_spec_rejected_typed():
    engine = _torch_engine()

    async def run():
        req = PreprocessedRequest(token_ids=[5, 9], guided={"kind": "grammar"})
        try:
            with pytest.raises(UnsupportedRequestError, match="guided spec rejected"):
                async for _ in engine.generate(req.to_dict(), Context()):
                    pass
        finally:
            await engine.close()

    asyncio.run(run())
