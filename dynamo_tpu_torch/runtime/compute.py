"""Compute pool: CPU-bound work off the event loop.

Port of `dynamo_tpu/runtime/compute.py`, unchanged.

The reference bridges a rayon thread pool into tokio so tokenization and
template rendering never stall the async runtime (lib/runtime/src/compute/
pool.rs, compute/mod.rs:31). Python analogue: a bounded ThreadPoolExecutor
shared process-wide — HF tokenizers release the GIL in their Rust core, so
encode work genuinely runs beside the event loop; pure-Python fallbacks
(byte tokenizer) still yield the loop between bytecodes instead of
monopolizing it for an entire long prompt.

Sizing: DYN_COMPUTE_THREADS env, default min(4, cpus). A request-serving
frontend should never need more — the pool exists for latency isolation,
not throughput.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
from typing import Any, Callable, Optional


class ComputePool:
    """Process-wide pool for tokenize/template/detok offload."""

    _instance: Optional["ComputePool"] = None

    def __init__(self, threads: Optional[int] = None):
        n = threads or int(
            os.environ.get("DYN_COMPUTE_THREADS")
            or min(4, os.cpu_count() or 1)
        )
        self.threads = max(1, n)
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.threads, thread_name_prefix="dyn-compute"
        )
        self.tasks_run = 0

    @classmethod
    def get(cls) -> "ComputePool":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    async def run(self, fn: Callable[..., Any], *args: Any) -> Any:
        self.tasks_run += 1
        return await asyncio.get_running_loop().run_in_executor(
            self._exec, fn, *args
        )

    def stats(self) -> dict:
        return {"compute_threads": self.threads, "compute_tasks_run": self.tasks_run}
