"""dynamo_tpu_torch: the PyTorch/CUDA port of dynamo-tpu for NVIDIA Hopper.

The JAX package `dynamo_tpu` is the reference and stays beside this one;
nothing here imports it (or jax). Module names mirror the reference so a
reader finds the counterpart. Layer map of what is ported so far:

  runtime/   — `Context` (cancellation) for in-process engine calls
  llm/       — engine-facing protocol types, token block hashing,
               the byte tokenizer, KV stored/removed events
  engine/    — `TorchEngine`: continuous batching over a paged KV pool,
               fused K-step decode blocks, batched chunked prefill, the
               ragged mixed prefill+decode step, on-device sampling,
               the SLA step scheduler
  models/    — Llama family as plain functions on tensors
  ops/       — paged attention ops: hand-written Hopper kernels
               (csrc/*.cu, built by ops/_build.py at first use) with a
               plain PyTorch version beside each, over full-precision or
               int8/int4 KV pages (kv_quant.py: quantize on write,
               dequantize inside the kernels)
                 hopper_paged_attention.py       — one-token decode
                 hopper_paged_attention_local.py — decode over the pool
                                                   + block-local KV
                 hopper_prefill_attention.py     — batched chunked prefill
                 hopper_ragged_attention.py      — ragged mixed prefill+decode

Every entry point defaults to `device="cuda"` and raises when there is no
card; only a caller that passes `device="cpu"` runs on the CPU, where the
attention ops use their plain versions.
"""
