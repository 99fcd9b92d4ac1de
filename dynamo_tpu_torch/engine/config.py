"""Engine configuration (vLLM-engine-args role) for the PyTorch/CUDA engine.

Field names and defaults are those of the JAX reference
(`dynamo_tpu/engine/config.py`) so a deployment description carries over.
Fields whose feature this port does not implement yet keep their names;
`unsupported_fields` lists the ones a config sets away from their "off"
value, and the engine refuses such a config with `UnsupportedConfigError`
instead of ignoring the field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


class UnsupportedConfigError(ValueError):
    """An `EngineConfig` field (or a request field) asks for a feature the
    port has not implemented. Raised, never silently ignored."""


@dataclass
class EngineConfig:
    model: str = "tiny"  # models registry key
    max_num_seqs: int = 64  # decode slot batch
    page_size: int = 64  # tokens per KV page == router block size
    # device page pool size; <= 0 sizes it from the device's free memory
    # once the weights are resident (engine.py:_auto_num_pages)
    num_pages: int = 2048
    max_model_len: int = 8192
    max_prefill_chunk: int = 1024  # chunked-prefill bucket cap
    prefill_buckets: tuple = (128, 256, 512, 1024)
    enable_prefix_caching: bool = True
    # fused decode: K steps per dispatch (one host read per K*B tokens);
    # speculated tokens past a stop condition are discarded (bounded waste)
    decode_block_steps: int = 8
    # KV-write strategy inside the decode block. "scatter" writes each
    # step's K/V into the pool (in place on this backend); "local" keeps
    # the pool read-only for the block's K steps — new K/V go into
    # per-layer block-local buffers that the attention kernel merges with
    # the pool — and commits them in ONE pool write per block. None
    # resolves to "scatter": in-place writes have none of the pool-copy
    # cost that makes the reference prefer "local" on its platform.
    decode_pool_mode: Optional[str] = None
    # a lax.scan unroll factor in the reference; accepted for the
    # configuration's sake and without effect here (no scan to unroll)
    decode_block_unroll: int = 0
    # batched prefill: token budget per dispatch; lanes = budget // bucket
    prefill_batch_tokens: int = 1024
    max_prefill_batch: int = 8
    # weight-only quantization: None | "int8" (per-channel f32 scales;
    # models/quant.py). Applies to the random init; a loaded checkpoint
    # arrives quantized from models/loader.py
    quantize: Optional[str] = None
    # KV page format: "none" | "int8" | "int4" (per-page-per-head f32
    # scales); None = DYN_KV_QUANT, else "none"
    kv_quant: Optional[str] = None
    # speculative decoding (engine/spec.py): "ngram" drafts spec_draft_len
    # tokens from the most recent spec_ngram-gram in a per-lane ring of the
    # last spec_hist tokens; each decode block runs spec_rounds
    # draft-verify rounds
    spec_mode: Optional[str] = None
    spec_draft_len: int = 4
    spec_ngram: int = 2
    spec_hist: int = 512  # history ring size (tokens) per lane
    spec_rounds: int = 4
    # sampling defaults
    default_temperature: float = 0.0
    seed: int = 0
    # OpenAI penalties window: recent tokens tracked per lane on device
    penalty_window: int = 256
    # parallelism (not ported: all must stay 1)
    tp_size: int = 1
    dp_size: int = 1
    pp_size: int = 1
    sp_size: int = 1
    ring_prefill_threshold: int = 512
    # scheduling
    max_queue: int = 4096
    decode_batch_wait_s: float = 0.0
    # SLA-aware step scheduling (engine/scheduler/). None = resolve from
    # the DYN_SCHED_POLICY / DYN_SLA_TTFT_MS / DYN_SLA_ITL_MS env knobs.
    sched_policy: Optional[str] = None
    ttft_target_ms: Optional[float] = None
    itl_target_ms: Optional[float] = None
    # ragged unified mixed dispatch: when the planner has BOTH runnable
    # prefill chunks and active decode lanes, pack them into ONE flat
    # ragged token buffer and ONE forward (models.llama.ragged_forward)
    # instead of a prefill dispatch followed by a decode dispatch.
    # None = on.
    mixed_dispatch: Optional[bool] = None
    # multi-LoRA (models/lora_pool.py): device adapter slots besides the
    # base slot 0; None = DYN_LORA_POOL_SLOTS (default 8)
    lora_pool_slots: Optional[int] = None
    # flat-token budget of one mixed dispatch: decode rows + granted
    # prefill chunks, pow2-bucketed up to this cap
    mixed_max_tokens: int = 2048
    # KVBM host/disk tiers (kvbm/): blocks of capacity each; a disk tier
    # needs its directory
    kvbm_host_blocks: int = 0
    kvbm_disk_blocks: int = 0
    kvbm_disk_path: Optional[str] = None
    # commit newly-full generated blocks during the step loop instead of
    # only at slot release. None = on.
    incremental_commit: Optional[bool] = None
    # serving role: "decode"/"both" serve whole requests (and decode
    # handed-off prompts), "prefill" answers disaggregated prefills; the
    # role at start (TorchEngine.morph re-roles a live engine)
    role: str = "decode"

    @property
    def max_pages_per_seq(self) -> int:
        return (self.max_model_len + self.page_size - 1) // self.page_size

    @property
    def block_advance(self) -> int:
        """Max tokens one fused block advances a lane: K decode steps, or
        spec_rounds draft-verify rounds of up to 1+d tokens."""
        if self.spec_mode:
            return self.spec_rounds * (self.spec_draft_len + 1)
        return self.decode_block_steps

    def unsupported_fields(self) -> List[str]:
        """Names of the fields set to a value this port cannot honour."""
        bad = []
        if self.spec_mode not in (None, "", "ngram"):
            bad.append("spec_mode")
        for name in ("tp_size", "dp_size", "pp_size", "sp_size"):
            if getattr(self, name) != 1:
                bad.append(name)
        if self.decode_pool_mode not in (None, "scatter", "local"):
            bad.append("decode_pool_mode")
        if self.role not in ("decode", "both", "prefill"):
            bad.append("role")
        return bad
