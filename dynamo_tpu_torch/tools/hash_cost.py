"""Host cost of the port's pure-Python block hash (XXH3-64 with seed).

    python3 dynamo_tpu_torch/tools/hash_cost.py [--tokens 64] [--blocks 2000]

Hashes `--blocks` chained blocks of `--tokens` random token ids each
(64 tokens = 256 bytes, the long path) with `compute_block_hash`, each
seeded by its parent as the prefix cache chains them, and prints one JSON
line: microseconds a block on this host's CPU, with the platform named.
A block is hashed once per committed page, not per token.
"""

from __future__ import annotations

import argparse
import json
import platform
import time

import numpy as np

from ..llm.tokens import compute_block_hash


def us_per_block(tokens: int = 64, blocks: int = 2000, seed: int = 0) -> float:
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 128256, size=(blocks, tokens)).tolist()
    parent = 0
    t0 = time.perf_counter()
    for block in data:
        parent = compute_block_hash(block, parent)
    return 1e6 * (time.perf_counter() - t0) / blocks


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=2000)
    args = ap.parse_args()
    us = us_per_block(args.tokens, args.blocks)
    print(json.dumps({"block_bytes": 4 * args.tokens, "blocks": args.blocks,
                      "us_per_block": round(us, 2), "cpu": cpu_name(),
                      "python": platform.python_version()}))


if __name__ == "__main__":
    main()
