"""Hierarchical runtime metrics registry, in the standard library.

Port of `dynamo_tpu/runtime/metrics.py` without `prometheus_client`: every
level of the DRT -> namespace -> component -> endpoint hierarchy mints
counters, gauges and histograms labelled with its position
(dynamo_namespace / dynamo_component / dynamo_endpoint) in one process-wide
registry, and `render()` writes them in the Prometheus text format.
Callback gauges are evaluated at render time. The metric-key registry
`METRICS` holds the reference's entries for the engine stats this port
publishes, spelled as the reference spells them.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

HIERARCHY_LABELS = ("dynamo_namespace", "dynamo_component", "dynamo_endpoint")

# Cross-process metric keys: spelled at the worker's stats() publisher and
# read by routers, gates and planners in other processes.
NUM_WAITING_REQS = "num_waiting_reqs"
NUM_RUNNING_REQS = "num_running_reqs"
KV_ACTIVE_BLOCKS = "kv_active_blocks"
KV_TOTAL_BLOCKS = "kv_total_blocks"
SCHED_EST_TTFT_MS = "sched_est_ttft_ms"
SCHED_EST_REQ_MS = "sched_est_req_ms"
SCHED_EST_PREFILL_TOK_S = "sched_est_prefill_tok_s"
SCHED_EST_DECODE_TOK_S = "sched_est_decode_tok_s"

#: The reference's registry entries (`dynamo_tpu/runtime/metrics.py:METRICS`)
#: for the stats `TorchEngine.stats()` publishes, the frontend's gate and
#: exposition and the KV router's index. `export=True` entries become
#: `dynamo_worker_<name>` gauges in the worker.
METRICS = {
    NUM_WAITING_REQS: {"kind": "gauge", "layer": "engine", "unit": "requests", "help": "Requests queued for prefill admission.", "wire": True, "export": True},
    NUM_RUNNING_REQS: {"kind": "gauge", "layer": "engine", "unit": "requests", "help": "Requests occupying decode slots.", "wire": True, "export": True},
    "gpu_cache_usage_perc": {"kind": "gauge", "layer": "engine", "unit": "fraction", "help": "Active KV pages / total pages.", "wire": True, "export": True},
    "request_total_slots": {"kind": "gauge", "layer": "engine", "unit": "slots", "help": "Configured max concurrent sequences.", "wire": True, "export": True},
    "kv_pool_bytes": {"kind": "gauge", "layer": "engine", "unit": "bytes", "help": "Resident KV pool bytes including scales.", "export": True},
    KV_ACTIVE_BLOCKS: {"kind": "gauge", "layer": "engine", "unit": "blocks", "help": "KV blocks referenced by live sequences.", "wire": True, "export": True},
    KV_TOTAL_BLOCKS: {"kind": "gauge", "layer": "engine", "unit": "blocks", "help": "Total KV blocks in the device pool.", "wire": True, "export": True},
    # ---- the KV data plane, disagg handoff and migration resumes ----
    "kv_format_mismatches": {"kind": "counter", "layer": "engine", "help": "Typed mixed-precision KV transfer rejections.", "export": True},
    "kv_transfers_served": {"kind": "counter", "layer": "engine", "help": "Data-plane KV transfers served to peers.", "export": True},
    "kv_bytes_served": {"kind": "counter", "layer": "engine", "unit": "bytes", "help": "Data-plane KV bytes served to peers.", "export": True},
    "kv_checkpoint_pushes": {"kind": "counter", "layer": "engine", "help": "Session-checkpoint pushes accepted into local tiers.", "export": True},
    "kv_checkpoint_blocks_received": {"kind": "counter", "layer": "engine", "unit": "blocks", "help": "Checkpoint blocks received from peers.", "export": True},
    "kv_pulls_completed": {"kind": "counter", "layer": "engine", "help": "Remote KV pulls completed (disagg onboarding).", "export": True},
    "kv_pages_pulled": {"kind": "counter", "layer": "engine", "unit": "blocks", "help": "KV pages pulled from remote workers.", "export": True},
    "disagg_streamed_handoffs": {"kind": "counter", "layer": "engine", "help": "Streamed prefill->decode handoffs started.", "export": True},
    "disagg_chunks_before_first_token": {"kind": "counter", "layer": "engine", "help": "KV chunks landed before the first decode token.", "export": True},
    "disagg_first_token_before_last_chunk": {"kind": "counter", "layer": "engine", "help": "First tokens emitted while KV chunks were in flight.", "export": True},
    "disagg_streamed_handoff_ratio": {"kind": "gauge", "layer": "engine", "unit": "fraction", "help": "Overlapped handoffs / streamed handoffs.", "export": True},
    "kv_streamed_stages": {"kind": "counter", "layer": "engine", "help": "Prefill-side streamed KV stages shipped.", "export": True},
    "kv_streamed_fallbacks": {"kind": "counter", "layer": "engine", "help": "Streamed handoffs that fell back to blocking pulls.", "export": True},
    "migrations_resumed": {"kind": "counter", "layer": "engine", "help": "Decode streams resumed here after a worker death.", "export": True},
    "migration_replayed_tokens": {"kind": "counter", "layer": "engine", "unit": "tokens", "help": "Tokens re-prefilled to resume migrated streams.", "export": True},
    "resume_source_checkpoint": {"kind": "counter", "layer": "engine", "help": "Migration resumes seeded from a peer checkpoint.", "export": True},
    "resume_source_peer": {"kind": "counter", "layer": "engine", "help": "Migration resumes seeded from live peer KV.", "export": True},
    "resume_source_local": {"kind": "counter", "layer": "engine", "help": "Migration resumes seeded from local tiers.", "export": True},
    "resume_source_recompute": {"kind": "counter", "layer": "engine", "help": "Migration resumes that fully re-prefilled.", "export": True},
    # role morphing: the live prefill<->decode re-role state machine
    "engine_role": {"kind": "info", "layer": "engine", "help": "Current serving role (prefill/decode/both/aggregated)."},
    "morph_state": {"kind": "info", "layer": "engine", "help": "Role-morph state machine position (serving/draining-role/flipped/warm)."},
    "morphs_completed": {"kind": "counter", "layer": "engine", "help": "Live role morphs that reached the new role's warm state.", "export": True},
    "morphs_rolled_back": {"kind": "counter", "layer": "engine", "help": "Role morphs that failed mid-flight and restored the original role.", "export": True},
    "morph_drained_sessions": {"kind": "counter", "layer": "engine", "help": "In-flight sessions severed to peers by morph drains (resumed via migration).", "export": True},
    "morph_last_duration_s": {"kind": "gauge", "layer": "engine", "unit": "seconds", "help": "Wall-clock of the last completed morph (drain + flip + re-warm).", "export": True},
    "kv_cached_blocks": {"kind": "gauge", "layer": "engine", "unit": "blocks", "help": "Unreferenced blocks held for prefix reuse.", "export": True},
    "kv_prefix_hit_blocks_total": {"kind": "counter", "layer": "engine", "unit": "blocks", "help": "Prefix-cache block hits at admission.", "export": True},
    "kv_skip_ahead_blocks": {"kind": "counter", "layer": "engine", "unit": "blocks", "help": "Prefill blocks skipped via prefix skip-ahead.", "export": True},
    "emit_batches": {"kind": "counter", "layer": "engine", "help": "Token delta batches emitted to streams.", "export": True},
    "emit_tokens": {"kind": "counter", "layer": "engine", "unit": "tokens", "help": "Tokens emitted to streams.", "export": True},
    "mixed_steps": {"kind": "counter", "layer": "engine", "help": "Fused mixed prefill+decode dispatch steps.", "export": True},
    "split_steps": {"kind": "counter", "layer": "engine", "help": "Split prefill/decode dispatch steps.", "export": True},
    "mixed_padding_frac": {"kind": "gauge", "layer": "engine", "unit": "fraction", "help": "Padding fraction paid by the mixed path.", "export": True},
    "split_padding_frac": {"kind": "gauge", "layer": "engine", "unit": "fraction", "help": "Padding fraction paid by the split path.", "export": True},
    "mixed_rows_plain": {"kind": "counter", "layer": "engine", "unit": "rows", "help": "Plain prefill/decode rows packed into fused mixed steps.", "export": True},
    "mixed_rows_guided": {"kind": "counter", "layer": "engine", "unit": "rows", "help": "Guided (FSM-masked) rows packed into fused mixed steps.", "export": True},
    "mixed_rows_spec": {"kind": "counter", "layer": "engine", "unit": "rows", "help": "Speculative verify rows packed into fused mixed steps.", "export": True},
    "mixed_rows_lora": {"kind": "counter", "layer": "engine", "unit": "rows", "help": "LoRA-adapter rows packed into fused mixed steps.", "export": True},
    "mixed_coverage_frac": {"kind": "gauge", "layer": "engine", "unit": "fraction", "help": "Fused steps / (fused + split) dispatch steps (1.0 before any step).", "export": True},
    # LoRA adapter tier (models/lora_pool.py): fixed-slot device stack
    # paging adapters device<->host
    "lora_pool_slots": {"kind": "gauge", "layer": "engine", "unit": "slots", "help": "Configured device adapter slots (DYN_LORA_POOL_SLOTS).", "export": True},
    "lora_pool_resident": {"kind": "gauge", "layer": "engine", "unit": "adapters", "help": "Adapters currently resident in device slots.", "export": True},
    "lora_pool_known": {"kind": "gauge", "layer": "engine", "unit": "adapters", "help": "Adapters registered in the host roster.", "export": True},
    "lora_pool_hits": {"kind": "counter", "layer": "engine", "help": "Adapter acquires served from a resident slot (hot switch).", "export": True},
    "lora_pool_misses": {"kind": "counter", "layer": "engine", "help": "Adapter acquires that paid a cold onboard.", "export": True},
    "lora_pool_evictions": {"kind": "counter", "layer": "engine", "help": "Unpinned adapters evicted from device slots (LRU).", "export": True},
    "lora_pool_refusals": {"kind": "counter", "layer": "engine", "help": "Typed adapter-tier refusals (pinned-full pool or injected onboard fault).", "export": True},
    "lora_pool_onboard_ms": {"kind": "counter", "layer": "engine", "unit": "ms", "help": "Cumulative adapter onboard latency (mean = sum/count).", "export": True},
    "lora_pool_onboard_count": {"kind": "counter", "layer": "engine", "help": "Adapter onboard operations.", "export": True},
    "lora_pool_onboard_ewma_ms": {"kind": "gauge", "layer": "engine", "unit": "ms", "help": "EWMA adapter onboard latency (cold-switch price).", "dynamic": True, "export": True},
    # guided and speculative decoding (llm/guided.py, engine/spec.py)
    "guided_requests": {"kind": "counter", "layer": "engine", "help": "Requests decoded under a guided-decoding FSM.", "export": True},
    "lora_requests": {"kind": "counter", "layer": "engine", "help": "Requests served through a LoRA adapter.", "export": True},
    "spec_num_drafts": {"kind": "counter", "layer": "engine", "help": "Speculative draft batches proposed.", "export": True},
    "spec_num_draft_tokens": {"kind": "counter", "layer": "engine", "unit": "tokens", "help": "Speculative tokens proposed by the draft model.", "export": True},
    "spec_num_accepted_tokens": {"kind": "counter", "layer": "engine", "unit": "tokens", "help": "Speculative tokens accepted by verification.", "export": True},
    "spec_mean_accepted_len": {"kind": "gauge", "layer": "engine", "unit": "tokens", "help": "Mean accepted length per draft (incl. bonus token).", "export": True},
    "sched_ttft_target_ms": {"kind": "gauge", "layer": "sched", "unit": "ms", "help": "Configured TTFT SLA target.", "export": True},
    "sched_itl_target_ms": {"kind": "gauge", "layer": "sched", "unit": "ms", "help": "Configured ITL SLA target.", "export": True},
    "sched_granted_chunks": {"kind": "counter", "layer": "sched", "help": "Prefill chunks granted by the budgeter.", "export": True},
    "sched_granted_tokens": {"kind": "counter", "layer": "sched", "unit": "tokens", "help": "Prefill tokens granted by the budgeter.", "export": True},
    "sched_deferred_steps": {"kind": "counter", "layer": "sched", "help": "Steps where prefill was deferred for ITL.", "export": True},
    "sched_itl_shrunk_steps": {"kind": "counter", "layer": "sched", "help": "Steps where the chunk budget was shrunk for ITL.", "export": True},
    "sched_deadline_overrides": {"kind": "counter", "layer": "sched", "help": "Deadline-driven priority overrides.", "export": True},
    "sched_starvation_overrides": {"kind": "counter", "layer": "sched", "help": "Starvation-guard priority overrides.", "export": True},
    "sched_pending_deadlines": {"kind": "gauge", "layer": "sched", "help": "Requests with an armed TTFT deadline.", "export": True},
    "sched_cost_observations": {"kind": "counter", "layer": "sched", "help": "Cost-model samples observed.", "export": True},
    "sched_tenants_served": {"kind": "gauge", "layer": "sched", "help": "Distinct tenants the fairness tiebreak has served.", "export": True},
    SCHED_EST_TTFT_MS: {"kind": "gauge", "layer": "sched", "unit": "ms", "help": "Projected TTFT for one more admitted request — the gate's admission ceiling and the disagg router's routing signal.", "wire": True, "export": True},
    SCHED_EST_REQ_MS: {"kind": "gauge", "layer": "sched", "unit": "ms", "help": "Marginal TTFT cost of one more admitted request (the gate's optimism debt between publishes).", "wire": True, "export": True},
    SCHED_EST_PREFILL_TOK_S: {"kind": "gauge", "layer": "sched", "unit": "tok/s", "help": "Per-worker marginal prefill throughput estimate from the cost-model EWMAs — prices the planner's re-role (morph vs spawn) decision.", "wire": True, "export": True},
    SCHED_EST_DECODE_TOK_S: {"kind": "gauge", "layer": "sched", "unit": "tok/s", "help": "Per-worker marginal decode throughput estimate from the cost-model EWMAs — prices the planner's re-role (morph vs spawn) decision.", "wire": True, "export": True},
    # ---- KVBM tiers / offload / checkpoint (kvbm/) ---------------------------------
    "kvbm_g1_hit_blocks": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Device prefix-cache hits at admission (G1).", "export": True},
    "kvbm_g1_miss_blocks": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Device prefix-cache misses at admission (G1).", "export": True},
    "kvbm_onboard_count": {"kind": "counter", "layer": "kvbm", "help": "Tier onboard operations.", "export": True},
    "kvbm_onboard_ms_sum": {"kind": "counter", "layer": "kvbm", "unit": "ms", "help": "Cumulative onboard latency (mean = sum/count).", "export": True},
    "kvbm_onboard_hist": {"kind": "histogram", "layer": "kvbm", "unit": "ms", "help": "Onboard latency histogram (stats-dict blob).", "buckets": (1.0, 5.0, 20.0, 100.0, 500.0)},
    "kvbm_offloaded_blocks": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Blocks offloaded device->host.", "export": True},
    "kvbm_onboarded_blocks": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Blocks onboarded back to device.", "export": True},
    "kvbm_disk_evictions": {"kind": "counter", "layer": "kvbm", "help": "Disk-tier evictions.", "dynamic": True, "export": True},
    "kvbm_dropped_blocks": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Blocks dropped out of the tier chain.", "export": True},
    "kvbm_host_eviction_policy": {"kind": "info", "layer": "kvbm", "help": "Host tier eviction policy name."},
    "kvbm_disk_eviction_policy": {"kind": "info", "layer": "kvbm", "help": "Disk tier eviction policy name."},
    "kvbm_host_blocks": {"kind": "gauge", "layer": "kvbm", "unit": "blocks", "help": "Blocks resident in the host tier (G2).", "dynamic": True, "export": True},
    "kvbm_host_capacity": {"kind": "gauge", "layer": "kvbm", "unit": "blocks", "help": "Host tier capacity.", "dynamic": True},
    "kvbm_host_hits": {"kind": "counter", "layer": "kvbm", "help": "Host tier lookup hits.", "dynamic": True, "export": True},
    "kvbm_host_misses": {"kind": "counter", "layer": "kvbm", "help": "Host tier lookup misses.", "dynamic": True, "export": True},
    "kvbm_host_evictions": {"kind": "counter", "layer": "kvbm", "help": "Host tier evictions.", "dynamic": True, "export": True},
    "kvbm_disk_blocks": {"kind": "gauge", "layer": "kvbm", "unit": "blocks", "help": "Blocks resident in the disk tier (G3).", "dynamic": True, "export": True},
    "kvbm_disk_capacity": {"kind": "gauge", "layer": "kvbm", "unit": "blocks", "help": "Disk tier capacity.", "dynamic": True},
    "kvbm_disk_hits": {"kind": "counter", "layer": "kvbm", "help": "Disk tier lookup hits.", "dynamic": True, "export": True},
    "kvbm_disk_misses": {"kind": "counter", "layer": "kvbm", "help": "Disk tier lookup misses.", "dynamic": True, "export": True},
    "kvbm_host_load_ms_per_block": {"kind": "gauge", "layer": "kvbm", "unit": "ms", "help": "Observed host-tier load cost per block.", "dynamic": True},
    "kvbm_disk_load_ms_per_block": {"kind": "gauge", "layer": "kvbm", "unit": "ms", "help": "Observed disk-tier load cost per block.", "dynamic": True},
    "kvbm_offload_commit_calls": {"kind": "counter", "layer": "kvbm", "help": "Offload commit batches entered.", "export": True},
    "kvbm_offload_gathers": {"kind": "counter", "layer": "kvbm", "help": "Device gathers staged for offload.", "export": True},
    "kvbm_offload_queue_depth": {"kind": "gauge", "layer": "kvbm", "help": "Offload batches waiting in the pipeline.", "export": True},
    "kvbm_offload_staged_blocks": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Blocks staged for offload.", "export": True},
    "kvbm_offload_batches_dropped": {"kind": "counter", "layer": "kvbm", "help": "Offload batches dropped under backpressure.", "export": True},
    "kvbm_offload_blocks_dropped": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Blocks dropped under offload backpressure.", "export": True},
    "kvbm_offload_failures": {"kind": "counter", "layer": "kvbm", "help": "Offload batches that failed.", "export": True},
    "kvbm_onboard_recompute_fallbacks": {"kind": "counter", "layer": "kvbm", "help": "Onboards that fell back to recompute.", "export": True},
    "kvbm_onboard_src_local_blocks": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Onboarded blocks sourced from local tiers.", "export": True},
    "kvbm_onboard_src_peer_blocks": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Onboarded blocks pulled from peers.", "export": True},
    "kvbm_onboard_src_recompute_blocks": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Onboard blocks recomputed.", "export": True},
    "kvbm_pending_offloads": {"kind": "gauge", "layer": "kvbm", "help": "Offload futures not yet committed.", "export": True},
    "kvbm_ckpt_blocks_staged": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Checkpoint blocks staged for replication.", "export": True},
    "kvbm_ckpt_blocks_pushed": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Checkpoint blocks pushed to replica holders.", "export": True},
    "kvbm_ckpt_bytes_pushed": {"kind": "counter", "layer": "kvbm", "unit": "bytes", "help": "Checkpoint bytes pushed to replica holders.", "export": True},
    "kvbm_ckpt_blocks_dropped": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Checkpoint blocks dropped (refuse-newest backpressure).", "export": True},
    "kvbm_ckpt_push_failures": {"kind": "counter", "layer": "kvbm", "help": "Checkpoint pushes that failed.", "export": True},
    "kvbm_ckpt_format_refusals": {"kind": "counter", "layer": "kvbm", "help": "Checkpoint pushes refused on KV-format mismatch.", "export": True},
    "kvbm_ckpt_queue_depth": {"kind": "gauge", "layer": "kvbm", "help": "Checkpoint batches waiting to push.", "export": True},
    "kvbm_ckpt_last_peer": {"kind": "info", "layer": "kvbm", "help": "Last checkpoint replica peer address."},
    "kvbm_remote_onboards": {"kind": "counter", "layer": "kvbm", "help": "Onboards served from remote peers.", "export": True},
    "kvbm_remote_blocks_pulled": {"kind": "counter", "layer": "kvbm", "unit": "blocks", "help": "Blocks pulled over the cluster KV fabric.", "export": True},
    "kvbm_peer_bytes_pulled": {"kind": "counter", "layer": "kvbm", "unit": "bytes", "help": "Bytes pulled over the cluster KV fabric.", "export": True},
    "kvbm_peer_pull_failures": {"kind": "counter", "layer": "kvbm", "help": "Peer pulls that failed (quarantine feed).", "export": True},
    "kvbm_peer_pull_ms_sum": {"kind": "counter", "layer": "kvbm", "unit": "ms", "help": "Cumulative peer-pull latency (mean = sum/onboards).", "export": True},
    "kvbm_peer_pull_hist": {"kind": "histogram", "layer": "kvbm", "unit": "ms", "help": "Peer-pull latency histogram (stats-dict blob).", "buckets": (5.0, 20.0, 50.0, 100.0, 250.0, 1000.0)},
    "kvbm_known_remote_blocks": {"kind": "gauge", "layer": "kvbm", "unit": "blocks", "help": "Remote blocks known to the fabric index.", "export": True},
    "kvbm_quarantined_peers": {"kind": "gauge", "layer": "kvbm", "help": "Peers currently quarantined after pull failures.", "export": True},
    "kvbm_known_checkpoint_blocks": {"kind": "gauge", "layer": "kvbm", "unit": "blocks", "help": "Checkpoint blocks known cluster-wide.", "export": True},
    "kvbm_ckpt_ineligible_peers": {"kind": "gauge", "layer": "kvbm", "help": "Peers refused as checkpoint targets (format skew).", "export": True},
    "kvbm_peer_ms_per_block": {"kind": "info", "layer": "kvbm", "unit": "ms", "help": "Per-peer observed pull cost map (addr -> ms/block)."},
    # ---- dynogate (gate/, frontend process) --------------------------
    "gate_enabled": {"kind": "gauge", "layer": "gate", "help": "1 when the admission gate is active."},
    "gate_admitted_total": {"kind": "counter", "layer": "gate", "help": "Requests admitted by the gate."},
    "gate_rejected_total": {"kind": "counter", "layer": "gate", "help": "Requests rejected (429) by the gate."},
    "gate_shed_total": {"kind": "counter", "layer": "gate", "help": "Parked requests shed before admission."},
    "gate_parked_total": {"kind": "counter", "layer": "gate", "help": "Requests parked in the admission queue."},
    "gate_queue_depth": {"kind": "gauge", "layer": "gate", "help": "Requests currently parked at the gate."},
    "gate_rejected_by_reason": {"kind": "info", "layer": "gate", "help": "Rejection counts keyed by reason (stats-dict map)."},
    "gate_retry_after_hist": {"kind": "histogram", "layer": "gate", "unit": "seconds", "help": "Retry-After values handed out (stats-dict blob).", "buckets": (1.0, 2.0, 5.0, 10.0)},
    "gate_per_tenant": {"kind": "info", "layer": "gate", "help": "Bounded per-tenant admit/reject map."},
    "gate_signal_samples": {"kind": "counter", "layer": "gate", "help": "Worker metric samples folded into gate signals."},
    # ---- frontend prometheus exposition (llm/http, llm/migration) ----
    "dynamo_frontend_requests_total": {"kind": "counter", "layer": "frontend", "unit": "requests", "help": "HTTP LLM requests completed.", "labels": ("model", "endpoint", "status"), "wire": True},
    "dynamo_frontend_inflight_requests": {"kind": "gauge", "layer": "frontend", "unit": "requests", "help": "Requests currently being processed.", "labels": ("model", "endpoint")},
    "dynamo_frontend_request_duration_seconds": {"kind": "histogram", "layer": "frontend", "unit": "seconds", "help": "End-to-end request duration.", "labels": ("model", "endpoint"), "wire": True, "buckets": (0.05, 0.1, 0.25, 0.5, 1, 2, 4, 8, 16, 32, 64, 128)},
    "dynamo_frontend_time_to_first_token_seconds": {"kind": "histogram", "layer": "frontend", "unit": "seconds", "help": "Time to first token.", "labels": ("model",), "wire": True, "buckets": (0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 6.4, 12.8)},
    "dynamo_frontend_output_tokens_total": {"kind": "counter", "layer": "frontend", "unit": "tokens", "help": "Generated tokens delivered to clients.", "labels": ("model",), "wire": True},
    "dynamo_frontend_input_tokens_total": {"kind": "counter", "layer": "frontend", "unit": "tokens", "help": "Prompt tokens accepted.", "labels": ("model",), "wire": True},
    "dynamo_frontend_inter_token_latency_seconds": {"kind": "histogram", "layer": "frontend", "unit": "seconds", "help": "Mean inter-token latency per request.", "labels": ("model",), "wire": True, "buckets": (0.002, 0.005, 0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 0.64, 1.28)},
    "dynamo_frontend_client_disconnects_total": {"kind": "counter", "layer": "frontend", "help": "Client disconnects mid-stream.", "labels": ("model",)},
    "dynamo_frontend_tokens_per_frame": {"kind": "histogram", "layer": "frontend", "unit": "tokens", "help": "Generated tokens per streamed delta batch.", "labels": ("model",), "buckets": (1, 2, 4, 8, 16, 32, 64, 128)},
    "dynamo_frontend_migrations_total": {"kind": "counter", "layer": "frontend", "help": "Stream migrations started after worker loss."},
    "dynamo_frontend_migration_replayed_tokens_total": {"kind": "counter", "layer": "frontend", "unit": "tokens", "help": "Tokens replayed into migration retry prompts."},
    "dynamo_frontend_migrations_exhausted_total": {"kind": "counter", "layer": "frontend", "help": "Streams that ran out of migration budget."},
    "dynamo_frontend_gate_admitted_total": {"kind": "counter", "layer": "gate", "help": "Gate admissions (exposition view)."},
    "dynamo_frontend_gate_rejected_total": {"kind": "counter", "layer": "gate", "help": "Gate rejections (exposition view)."},
    "dynamo_frontend_gate_shed_total": {"kind": "counter", "layer": "gate", "help": "Parked requests shed (exposition view)."},
    "dynamo_frontend_gate_queue_depth": {"kind": "gauge", "layer": "gate", "help": "Parked requests right now (exposition view)."},
    "dynamo_frontend_gate_rejected_by_reason_total": {"kind": "counter", "layer": "gate", "help": "Gate rejections by bounded reason.", "labels": ("reason",)},
    "dynamo_frontend_gate_tenant_requests_total": {"kind": "counter", "layer": "gate", "help": "Per-tenant admit/reject counts (bounded tenant set).", "labels": ("tenant", "outcome")},
    "dynamo_frontend_gate_retry_after_seconds": {"kind": "histogram", "layer": "gate", "unit": "seconds", "help": "Retry-After values handed out.", "buckets": (1.0, 2.0, 5.0, 10.0)},
    # ---- KV router / indexer (frontend process) ----------------------
    "index_blocks": {"kind": "gauge", "layer": "router", "unit": "blocks", "help": "Blocks tracked by the KV event index."},
    "index_max_blocks": {"kind": "gauge", "layer": "router", "unit": "blocks", "help": "Index capacity (0 = unbounded)."},
    "index_evicted_blocks": {"kind": "counter", "layer": "router", "unit": "blocks", "help": "Index entries evicted at capacity."},
    "index_mappings": {"kind": "gauge", "layer": "router", "help": "hash->worker mappings held."},
    "index_memory_bytes_estimate": {"kind": "gauge", "layer": "router", "unit": "bytes", "help": "Estimated index memory footprint."},
    "events_applied": {"kind": "counter", "layer": "router", "help": "KV events applied to the index."},
}

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                   1.0, 2.5, 5.0, 7.5, 10.0, math.inf)


def worker_exported_stats() -> Tuple[str, ...]:
    """Stats the worker republishes as `dynamo_worker_<name>` gauges."""
    return tuple(name for name, spec in METRICS.items() if spec.get("export"))


def metric_spec(name: str) -> Optional[dict]:
    return METRICS.get(name)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:
        return "NaN"
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


class _Child:
    """One labelled series of a metric (what `.labels(...)` returns)."""

    def __init__(self, metric: "_Metric", key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0):
        if self._metric.kind == "counter" and amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        with self._metric.lock:
            self._metric.values[self._key] = self._metric.values.get(self._key, 0.0) + amount

    def dec(self, amount: float = 1.0):
        if self._metric.kind == "counter":
            self._refuse("dec")
        self.inc(-amount)

    def set(self, value: float):
        if self._metric.kind != "gauge":
            self._refuse("set")
        with self._metric.lock:
            self._metric.values[self._key] = float(value)

    def observe(self, value: float):
        if self._metric.kind != "histogram":
            self._refuse("observe")
        m = self._metric
        with m.lock:
            counts, total = m.values.get(self._key, ([0] * len(m.buckets), 0.0))
            counts = list(counts)
            for i, le in enumerate(m.buckets):
                if value <= le:
                    counts[i] += 1
            m.values[self._key] = (counts, total + value)

    def get(self):
        return self._metric.values.get(self._key)

    def _refuse(self, op: str):
        raise TypeError(f"{self._metric.kind} {self._metric.name} has no {op}()")


class _Metric:
    def __init__(self, kind: str, name: str, doc: str, label_names: Tuple[str, ...],
                 buckets: Optional[Sequence[float]] = None):
        self.kind, self.name, self.doc = kind, name, doc
        self.label_names = label_names
        self.buckets = tuple(buckets or DEFAULT_BUCKETS)
        if self.buckets[-1] != math.inf:
            self.buckets += (math.inf,)
        self.values: Dict[Tuple[str, ...], object] = {}
        self.lock = threading.Lock()

    def labels(self, *values: str) -> _Child:
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels {self.label_names}, got {values}")
        return _Child(self, tuple(str(v) for v in values))

    def render(self, out: List[str], flat: bool = False):
        """Append the exposition lines. `flat` writes what prometheus_client
        writes for a flat registry: a counter's HELP/TYPE under its `_total`
        name and each sample's labels sorted by name, `le` among them."""
        sample = self.name + "_total" if self.kind == "counter" else self.name
        family = sample if flat else self.name
        out.append(f"# HELP {family} {self.doc}")
        out.append(f"# TYPE {family} {self.kind}")
        with self.lock:
            items = sorted(self.values.items())

        def fmt(pairs):
            if flat:
                pairs = sorted(pairs)
            return ",".join(f'{n}="{_escape(v)}"' for n, v in pairs)

        for key, val in items:
            pairs = list(zip(self.label_names, key))
            if self.kind != "histogram":
                out.append(f"{sample}{{{fmt(pairs)}}} {_fmt(val)}")
                continue
            counts, total = val
            for le, c in zip(self.buckets, counts):
                out.append(f'{self.name}_bucket{{{fmt(pairs + [("le", _fmt(le))])}}} {_fmt(c)}')
            out.append(f"{self.name}_count{{{fmt(pairs)}}} {_fmt(counts[-1])}")
            out.append(f"{self.name}_sum{{{fmt(pairs)}}} {_fmt(total)}")


class MetricsRegistry:
    """Per-hierarchy-level view over one process-wide registry (reference
    MetricsRegistry): children share it and add labels."""

    def __init__(
        self,
        prefix: str = "dynamo",
        _labels: Optional[Dict[str, str]] = None,
        _root: Optional["MetricsRegistry"] = None,
    ):
        self.prefix = prefix
        self.labels = dict(_labels or {})
        self._root = _root or self
        if _root is None:
            self._metrics: Dict[str, _Metric] = {}
            self._lock = threading.Lock()
            self._callbacks: List[Callable[[], None]] = []

    # -- hierarchy ----------------------------------------------------------
    def child(self, level: str, name: str) -> "MetricsRegistry":
        labels = dict(self.labels)
        labels[level] = name
        return MetricsRegistry(self.prefix, _labels=labels, _root=self._root)

    def for_namespace(self, name: str) -> "MetricsRegistry":
        return self.child("dynamo_namespace", name)

    def for_component(self, name: str) -> "MetricsRegistry":
        return self.child("dynamo_component", name)

    def for_endpoint(self, name: str) -> "MetricsRegistry":
        return self.child("dynamo_endpoint", name)

    # -- metric constructors -------------------------------------------------
    # every metric carries ALL hierarchy labels ("" when minted above that
    # level), so one metric can serve the same name from any depth
    def _label_values(self) -> Tuple[str, ...]:
        return tuple(self.labels.get(k, "") for k in HIERARCHY_LABELS)

    def _get_or_create(self, kind: str, name: str, doc: str,
                       extra_labels: Sequence[str], buckets=None):
        root = self._root
        full = f"{self.prefix}_{name}"
        names = HIERARCHY_LABELS + tuple(extra_labels)
        with root._lock:
            m = root._metrics.get(full)
            if m is None:
                m = _Metric(kind, full, doc, names, buckets)
                root._metrics[full] = m
            elif m.kind != kind or m.label_names != names:
                raise ValueError(
                    f"metric {full} already registered as {m.kind} with labels "
                    f"{m.label_names}, requested {kind} with {names}"
                )
            elif buckets is not None and m.buckets != _Metric(kind, full, doc, names, buckets).buckets:
                raise ValueError(f"metric {full} already registered with other buckets")
        return m

    def _series(self, m: _Metric, extra_labels: Sequence[str]):
        hier = self._label_values()
        return m.labels(*hier) if not extra_labels else _Partial(m, hier)

    def counter(self, name: str, doc: str = "", extra_labels: Sequence[str] = ()):
        return self._series(self._get_or_create("counter", name, doc or name, extra_labels),
                            extra_labels)

    def gauge(self, name: str, doc: str = "", extra_labels: Sequence[str] = ()):
        return self._series(self._get_or_create("gauge", name, doc or name, extra_labels),
                            extra_labels)

    def histogram(self, name: str, doc: str = "", extra_labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None):
        m = self._get_or_create("histogram", name, doc or name, extra_labels, buckets)
        return self._series(m, extra_labels)

    def callback_gauge(self, name: str, doc: str, fn: Callable[[], float]):
        """Gauge whose value is `fn()` at render time (reference metrics
        callbacks). A callback that raises leaves the last value."""
        g = self.gauge(name, doc)

        def update():
            try:
                g.set(fn())
            except Exception:  # noqa: BLE001 — a render must not die
                pass

        self._root._callbacks.append(update)
        return g

    # -- export ---------------------------------------------------------------
    def render(self) -> bytes:
        """Every metric in the Prometheus text exposition format."""
        root = self._root
        for cb in root._callbacks:
            cb()
        out: List[str] = []
        with root._lock:
            metrics = [root._metrics[k] for k in sorted(root._metrics)]
        for m in metrics:
            m.render(out)
        return ("\n".join(out) + "\n").encode()


class CollectorRegistry:
    """A flat registry of metrics with their own label names and no prefix
    or hierarchy labels (prometheus_client's `CollectorRegistry` role, as
    the frontend's HTTP metrics use it). A counter named `x_total` is the
    family `x`, its samples `x_total`, as prometheus_client names them."""

    def __init__(self):
        self._metrics: List[_Metric] = []

    def _add(self, kind: str, name: str, doc: str, labels: Sequence[str], buckets=None):
        m = _Metric(kind, name, doc, tuple(labels), buckets)
        self._metrics.append(m)
        return m

    def counter(self, name: str, doc: str, labels: Sequence[str] = ()) -> _Metric:
        return self._add("counter", name.removesuffix("_total"), doc, labels)

    def gauge(self, name: str, doc: str, labels: Sequence[str] = ()) -> _Metric:
        return self._add("gauge", name, doc, labels)

    def histogram(self, name: str, doc: str, labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> _Metric:
        return self._add("histogram", name, doc, labels, buckets)

    def render(self) -> bytes:
        out: List[str] = []
        for m in self._metrics:
            m.render(out, flat=True)
        return ("\n".join(out) + "\n").encode()


class _Partial:
    """A metric with extra labels: `.labels(*extra)` completes the series."""

    def __init__(self, metric: _Metric, hier_values: Tuple[str, ...]):
        self._metric = metric
        self._hier = hier_values

    def labels(self, *values: str):
        return self._metric.labels(*self._hier, *values)
