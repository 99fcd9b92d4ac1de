"""Reader and writer of the safetensors format, on the standard library.

The format: an 8-byte little-endian header length N, N bytes of JSON (one
entry per tensor: `dtype`, `shape`, `data_offsets` [begin, end) into the
byte buffer that follows the header; an optional `__metadata__` map of
strings), then the raw little-endian tensor bytes. This module reads and
writes F32, F16 and BF16 tensors. BF16 has no numpy dtype: a tensor is
read as raw bytes into a fresh host buffer and viewed as its torch dtype
(`torch.bfloat16` included).

Reads are lazy, one tensor at a time (`SafetensorsFile.get`): the buffer
is the only host copy and is freed with the tensor, so loading a
checkpoint tensor by tensor holds about one tensor of it in host memory.
A memory map is not used: under gVisor the mapped pages
stay resident after `madvise(MADV_DONTNEED)`, so a 6.4 GB load grew the
process by about 6 GB where these reads hold one tensor.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

DTYPES: Dict[str, torch.dtype] = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
}
NAMES: Dict[torch.dtype, str] = {v: k for k, v in DTYPES.items()}
INDEX_NAME = "model.safetensors.index.json"
SINGLE_NAME = "model.safetensors"


class SafetensorsFile:
    """One .safetensors file: its header parsed at open, tensors read on
    demand."""

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._entries = header
        self._base = 8 + n

    def keys(self) -> List[str]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._entries[name]["shape"])

    def dtype(self, name: str) -> torch.dtype:
        code = self._entries[name]["dtype"]
        if code not in DTYPES:
            raise ValueError(f"{self.path}: {name} has dtype {code}; F32, F16 and BF16 are read")
        return DTYPES[code]

    def get(self, name: str) -> torch.Tensor:
        """The tensor, read from the file into a new CPU tensor."""
        e = self._entries[name]
        begin, end = e["data_offsets"]
        buf = torch.empty(end - begin, dtype=torch.uint8)
        if end > begin:
            with open(self.path, "rb") as f:
                f.seek(self._base + begin)
                if f.readinto(buf.numpy()) != end - begin:
                    raise ValueError(f"{self.path}: {name} is cut short")
        return buf.view(self.dtype(name)).reshape(e["shape"])


def _size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x.detach()


def _layout(items: Iterable[Tuple[str, torch.Tensor]], dtype: Optional[torch.dtype]):
    """The header entries and total bytes of the tensors, in order."""
    header, off = {}, 0
    for name, t in items:
        dt = dtype or t.dtype
        if dt not in NAMES:
            raise ValueError(f"{name}: dtype {dt} is not written (F32, F16, BF16)")
        n = t.numel() * _size(dt)
        header[name] = {"dtype": NAMES[dt], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    return header, off


def save_file(tensors: Mapping[str, object], path, metadata: Optional[Dict[str, str]] = None,
              dtype: Optional[torch.dtype] = None) -> int:
    """Write `tensors` (torch tensors on any device, or numpy arrays) to one
    .safetensors file, each cast to `dtype` when given. Each tensor is
    moved to the host only while it is written. Returns the data bytes."""
    items = [(k, _as_tensor(v)) for k, v in tensors.items()]
    header, total = _layout(items, dtype)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data buffer starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            # cast and lay out where the tensor lives, then one copy to the host
            t = t.to(dtype=dtype or t.dtype).contiguous().cpu().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy())
    return total


def save_sharded(tensors: Mapping[str, object], out_dir, max_shard_bytes: int,
                 dtype: Optional[torch.dtype] = None) -> List[str]:
    """Write `tensors` as HF does for a large checkpoint: consecutive shards
    `model-0000i-of-0000N.safetensors` of at most `max_shard_bytes` each
    (a larger single tensor gets a shard of its own) and the index
    `model.safetensors.index.json` mapping every name to its shard. One
    shard is written as `model.safetensors` with no index. Returns the
    file names."""
    os.makedirs(out_dir, exist_ok=True)
    items = [(k, _as_tensor(v)) for k, v in tensors.items()]
    shards: List[List[Tuple[str, torch.Tensor]]] = [[]]
    used = 0
    for name, t in items:
        n = t.numel() * _size(dtype or t.dtype)
        if shards[-1] and used + n > max_shard_bytes:
            shards.append([])
            used = 0
        shards[-1].append((name, t))
        used += n
    if len(shards) == 1:
        save_file(dict(items), Path(out_dir) / SINGLE_NAME, {"format": "pt"}, dtype)
        return [SINGLE_NAME]
    names, weight_map, total = [], {}, 0
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        total += save_file(dict(shard), Path(out_dir) / fname, {"format": "pt"}, dtype)
        weight_map.update({name: fname for name, _ in shard})
        names.append(fname)
    (Path(out_dir) / INDEX_NAME).write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    return names + [INDEX_NAME]
