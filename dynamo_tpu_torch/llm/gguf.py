"""GGUF file parsing: header, metadata KVs, embedded tokenizer, tensors.

Port of `dynamo_tpu/llm/gguf.py` (which holds no JAX), kept as the port's
own copy: read enough of a .gguf checkpoint to build a
ModelDeploymentCard, and its tensor table and data (f32 / f16 / q8_0), so
a .gguf checkpoint loads straight into the engine (models/loader.py gguf
path). `write_gguf` writes the same bytes as the reference's; it encodes
a tensor in slices, so a large q8_0 tensor never needs several f32 copies
of itself at once.
Spec: https://github.com/ggml-org/ggml/blob/master/docs/gguf.md
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, BinaryIO, Dict, List, Optional

GGUF_MAGIC = b"GGUF"
GGUF_ALIGNMENT = 32  # spec default (general.alignment overrides)

# ggml tensor dtypes we read/write
GGML_F32, GGML_F16, GGML_Q8_0 = 0, 1, 8
Q8_0_BLOCK = 32  # elements per q8_0 block (f16 scale + 32 int8)

# metadata value type ids (gguf spec)
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL = range(8)
T_STRING, T_ARRAY, T_U64, T_I64, T_F64 = 8, 9, 10, 11, 12

_SCALARS = {
    T_U8: ("<B", 1), T_I8: ("<b", 1), T_U16: ("<H", 2), T_I16: ("<h", 2),
    T_U32: ("<I", 4), T_I32: ("<i", 4), T_F32: ("<f", 4), T_BOOL: ("<?", 1),
    T_U64: ("<Q", 8), T_I64: ("<q", 8), T_F64: ("<d", 8),
}


def _read_scalar(f: BinaryIO, vtype: int):
    fmt, size = _SCALARS[vtype]
    return struct.unpack(fmt, f.read(size))[0]


def _read_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int):
    if vtype in _SCALARS:
        return _read_scalar(f, vtype)
    if vtype == T_STRING:
        return _read_string(f)
    if vtype == T_ARRAY:
        (elem_type,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, elem_type) for _ in range(count)]
    raise ValueError(f"unknown gguf metadata type {vtype}")


@dataclass
class GgufTensorInfo:
    name: str
    shape: tuple  # numpy order (ggml's ne[] is reversed: ne[0] = innermost)
    ggml_type: int
    offset: int  # within the aligned data blob


@dataclass
class GgufContent:
    version: int
    tensor_count: int
    metadata: Dict[str, Any] = field(default_factory=dict)
    # populated by read_gguf(with_tensors=True):
    tensors: Dict[str, GgufTensorInfo] = field(default_factory=dict)
    data_start: int = 0
    path: Optional[str] = None

    # -- typed accessors over the conventional keys ------------------------
    @property
    def architecture(self) -> Optional[str]:
        return self.metadata.get("general.architecture")

    @property
    def name(self) -> Optional[str]:
        return self.metadata.get("general.name")

    def arch_key(self, suffix: str):
        arch = self.architecture
        return self.metadata.get(f"{arch}.{suffix}") if arch else None

    @property
    def context_length(self) -> Optional[int]:
        return self.arch_key("context_length")

    @property
    def num_layers(self) -> Optional[int]:
        return self.arch_key("block_count")

    @property
    def num_heads(self) -> Optional[int]:
        return self.arch_key("attention.head_count")

    @property
    def num_kv_heads(self) -> Optional[int]:
        return self.arch_key("attention.head_count_kv") or self.num_heads

    @property
    def hidden_size(self) -> Optional[int]:
        return self.arch_key("embedding_length")

    # -- embedded tokenizer (gguf_tokenizer.rs role) -----------------------
    @property
    def tokenizer_model(self) -> Optional[str]:
        return self.metadata.get("tokenizer.ggml.model")

    @property
    def tokens(self) -> Optional[List[str]]:
        return self.metadata.get("tokenizer.ggml.tokens")

    @property
    def bos_token_id(self) -> Optional[int]:
        return self.metadata.get("tokenizer.ggml.bos_token_id")

    @property
    def eos_token_id(self) -> Optional[int]:
        return self.metadata.get("tokenizer.ggml.eos_token_id")

    @property
    def chat_template(self) -> Optional[str]:
        return self.metadata.get("tokenizer.chat_template")


def read_gguf(path, with_tensors: bool = False) -> GgufContent:
    """Parse header + metadata; with_tensors=True also parses the tensor
    table and records the aligned data-blob offset for load_tensor."""
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        (version,) = struct.unpack("<I", f.read(4))
        if version < 2:
            raise ValueError(f"{path}: gguf v{version} unsupported (need >= 2)")
        (tensor_count,) = struct.unpack("<Q", f.read(8))
        (kv_count,) = struct.unpack("<Q", f.read(8))
        meta: Dict[str, Any] = {}
        for _ in range(kv_count):
            key = _read_string(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            meta[key] = _read_value(f, vtype)
        tensors: Dict[str, GgufTensorInfo] = {}
        data_start = 0
        if with_tensors:
            for _ in range(tensor_count):
                name = _read_string(f)
                (n_dims,) = struct.unpack("<I", f.read(4))
                dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
                (ggml_type,) = struct.unpack("<I", f.read(4))
                (offset,) = struct.unpack("<Q", f.read(8))
                tensors[name] = GgufTensorInfo(
                    name=name, shape=tuple(reversed(dims)),
                    ggml_type=ggml_type, offset=offset,
                )
            align = int(meta.get("general.alignment", GGUF_ALIGNMENT))
            pos = f.tell()
            data_start = (pos + align - 1) // align * align
    return GgufContent(
        version=version, tensor_count=tensor_count, metadata=meta,
        tensors=tensors, data_start=data_start, path=str(path),
    )


def load_tensor(content: GgufContent, name: str):
    """Read one tensor as float32 numpy (f32 / f16 / q8_0)."""
    import numpy as np

    info = content.tensors[name]
    n = 1
    for d in info.shape:
        n *= d
    with open(content.path, "rb") as f:
        f.seek(content.data_start + info.offset)
        if info.ggml_type == GGML_F32:
            arr = np.fromfile(f, dtype="<f4", count=n)
        elif info.ggml_type == GGML_F16:
            arr = np.fromfile(f, dtype="<f2", count=n).astype(np.float32)
        elif info.ggml_type == GGML_Q8_0:
            if n % Q8_0_BLOCK:
                raise ValueError(f"{name}: q8_0 size {n} not /{Q8_0_BLOCK}")
            blocks = np.fromfile(
                f, dtype=np.dtype([("d", "<f2"), ("qs", "i1", (Q8_0_BLOCK,))]),
                count=n // Q8_0_BLOCK,
            )
            arr = (
                blocks["d"].astype(np.float32)[:, None]
                * blocks["qs"].astype(np.float32)
            ).reshape(-1)
        else:
            raise ValueError(
                f"{name}: ggml type {info.ggml_type} unsupported "
                f"(f32/f16/q8_0 only)"
            )
    return np.asarray(arr, np.float32).reshape(info.shape)


def mdc_from_gguf(path, kv_cache_block_size: int = 64):
    """Build a ModelDeploymentCard from a .gguf file (reference
    LocalModelBuilder's GGUF path, local_model.rs:44)."""
    from .model_card import ModelDeploymentCard

    g = read_gguf(path)
    name = g.name or Path(path).stem
    card = ModelDeploymentCard(
        name=name,
        tokenizer=f"gguf:{path}",
        context_length=g.context_length or 8192,
        kv_cache_block_size=kv_cache_block_size,
        chat_template=g.chat_template,
    )
    card.runtime_config["gguf"] = {
        "architecture": g.architecture,
        "num_layers": g.num_layers,
        "num_heads": g.num_heads,
        "num_kv_heads": g.num_kv_heads,
        "hidden_size": g.hidden_size,
        "tokenizer_model": g.tokenizer_model,
        "bos_token_id": g.bos_token_id,
        "eos_token_id": g.eos_token_id,
    }
    return card


def write_gguf(path, metadata: Dict[str, Any], tensor_count: int = 0,
               tensors: Optional[Dict[str, Any]] = None,
               tensor_types: Optional[Dict[str, int]] = None) -> None:
    """Minimal GGUF writer — testing and interchange. `tensors` maps
    name -> float32 ndarray; `tensor_types` picks GGML_F32 (default),
    GGML_F16 or GGML_Q8_0 per tensor (q8_0 quantizes on write)."""
    import numpy as np

    def w_string(f, s: str):
        b = s.encode()
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def w_value(f, v):
        if isinstance(v, bool):
            f.write(struct.pack("<I", T_BOOL))
            f.write(struct.pack("<?", v))
        elif isinstance(v, int):
            f.write(struct.pack("<I", T_I64))
            f.write(struct.pack("<q", v))
        elif isinstance(v, float):
            f.write(struct.pack("<I", T_F64))
            f.write(struct.pack("<d", v))
        elif isinstance(v, str):
            f.write(struct.pack("<I", T_STRING))
            w_string(f, v)
        elif isinstance(v, list):
            f.write(struct.pack("<I", T_ARRAY))
            if v and isinstance(v[0], str):
                f.write(struct.pack("<I", T_STRING))
                f.write(struct.pack("<Q", len(v)))
                for s in v:
                    w_string(f, s)
            else:
                f.write(struct.pack("<I", T_I64))
                f.write(struct.pack("<Q", len(v)))
                for x in v:
                    f.write(struct.pack("<q", x))
        else:
            raise TypeError(f"unsupported gguf value {type(v)}")

    def encode_slice(flat: "np.ndarray", t: int) -> bytes:
        flat = np.asarray(flat, np.float32)
        if t == GGML_F32:
            return flat.astype("<f4").tobytes()
        if t == GGML_F16:
            return flat.astype("<f2").tobytes()
        if t == GGML_Q8_0:
            b = flat.reshape(-1, Q8_0_BLOCK)
            d = np.maximum(np.abs(b).max(axis=1), 1e-12) / 127.0
            qs = np.clip(np.round(b / d[:, None]), -127, 127).astype(np.int8)
            out = np.empty(
                b.shape[0],
                np.dtype([("d", "<f2"), ("qs", "i1", (Q8_0_BLOCK,))]),
            )
            out["d"] = d.astype("<f2")
            out["qs"] = qs
            return out.tobytes()
        raise ValueError(f"unsupported write type {t}")

    def encode_tensor(arr: "np.ndarray", t: int) -> bytes:
        flat = np.asarray(arr).reshape(-1)
        if t == GGML_Q8_0 and flat.size % Q8_0_BLOCK:
            raise ValueError(f"q8_0 needs size /{Q8_0_BLOCK}")
        step = Q8_0_BLOCK << 16  # whole q8_0 blocks per slice
        return b"".join(encode_slice(flat[i:i + step], t)
                        for i in range(0, max(flat.size, 1), step))

    tensors = tensors or {}
    tensor_types = tensor_types or {}
    align = int(metadata.get("general.alignment", GGUF_ALIGNMENT))
    with open(path, "wb") as f:
        f.write(GGUF_MAGIC)
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<Q", tensor_count or len(tensors)))
        f.write(struct.pack("<Q", len(metadata)))
        for k, v in metadata.items():
            w_string(f, k)
            w_value(f, v)
        if tensors:
            blobs = []
            offset = 0
            for name, arr in tensors.items():
                t = tensor_types.get(name, GGML_F32)
                blob = encode_tensor(arr, t)
                w_string(f, name)
                dims = tuple(reversed(arr.shape))  # ggml ne order
                f.write(struct.pack("<I", len(dims)))
                f.write(struct.pack(f"<{len(dims)}Q", *dims))
                f.write(struct.pack("<I", t))
                f.write(struct.pack("<Q", offset))
                blobs.append(blob)
                offset += (len(blob) + align - 1) // align * align
            pos = f.tell()
            f.write(b"\x00" * (-pos % align))
            for blob in blobs:
                f.write(blob)
                f.write(b"\x00" * (-len(blob) % align))
