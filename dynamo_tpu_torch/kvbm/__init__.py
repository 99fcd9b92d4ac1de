"""KVBM — the multi-tier KV block manager of the PyTorch/CUDA port.

Port of `dynamo_tpu/kvbm` (tiers after the reference's CacheLevel):
  G1  device memory — the engine's paged KV pool (engine/kv_cache.py)
  G2  host RAM      — one preallocated (pinned) tensor
  G3  local disk    — k.bin / v.bin pool files read and written with pread/pwrite
  G4  peer workers  — their G2/G3, pulled over the KV data plane

Blocks move with the engine's page gather and scatter
(`ops/kv_quant.py:extract_pages` / `inject_pages`) and copies on the side
stream. Offload is write-through at block-commit time, so a G1 eviction
never needs a device read-back.
"""

from .checkpoint import KvCheckpointer
from .distributed import KvbmDistributed
from .manager import KvbmConfig, KvBlockManager, KvbmConnector
from .storage import DiskTier, HostTier

__all__ = [
    "DiskTier",
    "HostTier",
    "KvCheckpointer",
    "KvbmConfig",
    "KvBlockManager",
    "KvbmConnector",
    "KvbmDistributed",
]
