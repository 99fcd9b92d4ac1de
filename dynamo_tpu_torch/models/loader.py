"""Checkpoint loading into the port's llama and MoE parameter trees.

Port of `dynamo_tpu/models/loader.py`: HF safetensors checkpoints (one
file, or shards behind `model.safetensors.index.json`) and .gguf files
(f32 / f16 / q8_0), each optionally quantized to int8 weight-only leaves
on load (`quantize="int8"`, models/quant.py). HF stores a linear weight
[out_features, in_features]; the tree holds [in, out] (x @ W), so
projections transpose on load. MoE checkpoints (`load_moe_params`) use
Mixtral's naming (`block_sparse_moe.gate`, `experts.N.w1/w3/w2`) or, in a
.gguf, llama.cpp's (`ffn_gate_inp`, `ffn_{gate,up,down}_exps`); their
expert stacks load as [L, E, in, out] (int8: one (layer, expert) matrix
at a time, scales [L, E, 1, out]) and the router stays f32.

Memory: every layer-stacked leaf is allocated once on the target device
at its full [L, ...] size and filled one layer at a time — a layer is read
from the checkpoint (safetensors: its bytes into a fresh buffer; GGUF: one
decoded f32 array), moved to the device, transposed and cast (or
quantized) into its slice, and dropped. So at most one layer's tensor is
transient on the host, and a full-depth load never holds the model twice
in host memory.

Model resolution is offline: a local path is used as it is, and an HF
repo id `org/name` resolves only through the HF hub cache's on-disk layout
(`models--org--name/refs/<revision>` -> `snapshots/<hash>`). Nothing is
ever downloaded.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from ..engine.config import UnsupportedConfigError
from .llama import LlamaConfig
from .moe import MoeConfig
from .quant import _LAYER_LEAVES, empty_quant, is_quant, quantize_into
from .safetensors_io import INDEX_NAME, SINGLE_NAME, SafetensorsFile, save_file, save_sharded

__all__ = [
    "config_from_gguf",
    "depth_from_hf",
    "load_llama_params",
    "load_llama_params_gguf",
    "load_moe_params",
    "resolve_model_path",
    "save_llama_as_gguf",
    "save_llama_as_hf",
    "save_moe_as_hf",
]


def _looks_like_repo_id(s: str) -> bool:
    """org/name shape, no leading slash or drive, at most one separator."""
    if s.startswith(("/", ".", "~")) or "\\" in s:
        return False
    parts = s.split("/")
    return len(parts) == 2 and all(p and not p.startswith(".") for p in parts)


def hub_cache_dir() -> Path:
    """The HF hub cache directory, by the hub's own environment rules."""
    for var in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE"):
        if os.environ.get(var):
            return Path(os.path.expanduser(os.environ[var]))
    if os.environ.get("HF_HOME"):
        return Path(os.path.expanduser(os.environ["HF_HOME"])) / "hub"
    xdg = os.environ.get("XDG_CACHE_HOME") or os.path.join("~", ".cache")
    return Path(os.path.expanduser(xdg)) / "huggingface" / "hub"


def _cached_snapshot(repo_id: str, revision: Optional[str]) -> Optional[Path]:
    """snapshots/<hash> of a cached repo (`refs/<revision>` names the hash;
    a revision that is itself a cached hash works too), or None."""
    repo = hub_cache_dir() / ("models--" + repo_id.replace("/", "--"))
    rev = revision or "main"
    ref = repo / "refs" / rev
    commit = ref.read_text().strip() if ref.is_file() else rev
    snap = repo / "snapshots" / commit
    return snap if snap.is_dir() else None


def resolve_model_path(path_or_repo: str, revision: Optional[str] = None,
                       allow_download: Optional[bool] = None) -> str:
    """A local checkpoint path, or an HF repo id resolved through the hub
    cache (the reference's local-path-else-hub contract, offline only).

    A repo that is not cached raises FileNotFoundError; asking for a
    download (`allow_download=True` or `DYN_HF_ALLOW_DOWNLOAD=1`) raises
    UnsupportedConfigError instead: the port never downloads."""
    p = Path(os.path.expanduser(path_or_repo))
    if p.exists():
        return str(p)
    if not _looks_like_repo_id(path_or_repo):
        raise FileNotFoundError(
            f"model path {path_or_repo!r} does not exist and is not an HF repo id")
    snap = _cached_snapshot(path_or_repo, revision)
    if snap is not None:
        return str(snap)
    if allow_download is None:
        allow_download = os.environ.get("DYN_HF_ALLOW_DOWNLOAD", "").strip().lower() in (
            "1", "true", "yes", "on")
    if allow_download:
        raise UnsupportedConfigError(
            f"{path_or_repo!r} is not in the HF cache ({hub_cache_dir()}) and the "
            "PyTorch/CUDA port does not download models; fetch it into the cache "
            "or pass a local directory")
    raise FileNotFoundError(
        f"{path_or_repo!r} is not a local path and not in the HF cache "
        f"({hub_cache_dir()}); set DYN_HF_ALLOW_DOWNLOAD=1 (or pass "
        f"allow_download=True) to fetch it from the hub")


class _Checkpoint:
    """Tensor name -> lazily read CPU tensor, over one or more files."""

    def __init__(self, files: Dict[str, SafetensorsFile]):
        self._files = files

    def __contains__(self, name: str) -> bool:
        return name in self._files

    def keys(self):
        return self._files.keys()

    def get(self, name: str) -> torch.Tensor:
        return self._files[name].get(name)


def _open_checkpoint(model_dir: str) -> _Checkpoint:
    """The checkpoint under `model_dir`, single-file or index-sharded."""
    d = Path(resolve_model_path(model_dir))
    index = d / INDEX_NAME
    files: Dict[str, SafetensorsFile] = {}
    if index.exists():
        opened: Dict[str, SafetensorsFile] = {}
        for name, fn in json.loads(index.read_text())["weight_map"].items():
            if fn not in opened:
                opened[fn] = SafetensorsFile(d / fn)
            files[name] = opened[fn]
    else:
        sts = sorted(d.glob("*.safetensors"))
        if not sts:
            raise FileNotFoundError(f"no safetensors files under {model_dir}")
        for st in sts:
            f = SafetensorsFile(st)
            files.update({name: f for name in f.keys()})
    return _Checkpoint(files)


class _Filler:
    """Device leaves filled matrix by matrix from host tensors, each read by
    `get(name)` and dropped once copied."""

    def __init__(self, config: LlamaConfig, quantize: Optional[str], device,
                 get: Callable[[str], torch.Tensor]):
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.c, self.quantize, self.device = config, quantize, torch.device(device)
        self.get = get

    def stacked(self, key: str, fmt: str, transpose: bool, experts: int = 0):
        """[L, ...] leaf of `key` from the tensors `fmt.format(li=li)`, or an
        expert stack [L, E, ...] from `fmt.format(li=li, e=e)` when
        `experts`; each stored with its last two axes [out, in] when
        `transpose`. A tensor may itself hold a layer's experts (GGUF)."""
        out = None
        lead = (self.c.num_layers, experts) if experts else (self.c.num_layers,)
        for idx in itertools.product(*map(range, lead)):
            name = fmt.format(li=idx[0], e=idx[-1])
            t = self.get(name).to(self.device)
            if transpose:
                t = t.transpose(-1, -2)
            if out is None:
                out = self._alloc(key, (*lead, *t.shape))
            if is_quant(out):
                # one matrix at a time (a GGUF layer tensor holds E of them)
                for j in itertools.product(*map(range, t.shape[:-2])):
                    quantize_into(out["q"][idx + j], out["s"][idx + j], t[j])
            else:
                out[idx].copy_(t)
            del t
        return out

    def _alloc(self, key: str, shape: tuple):
        if self.quantize == "int8" and key in _LAYER_LEAVES:
            return empty_quant(shape, self.device)
        # the MoE router stays f32 (routing decisions are numerically sensitive)
        dtype = torch.float32 if key == "router" else self.c.dtype
        return torch.empty(shape, dtype=dtype, device=self.device)

    def single(self, name: str, quant: bool, contract_axis: int = -2, transpose: bool = False):
        """A whole leaf: the embedding (per-row scales, contract_axis=-1),
        the head (stored [out, in]: `transpose`) or a norm."""
        t = self.get(name).to(self.device)
        if transpose:
            t = t.t()
        if quant and self.quantize == "int8":
            out = empty_quant(t.shape, self.device, contract_axis)
            quantize_into(out["q"], out["s"], t, contract_axis)
        else:
            out = torch.empty(t.shape, dtype=self.c.dtype, device=self.device)
            out.copy_(t)
        return out


_HF_LAYER = {
    # tree key -> (HF name in layer li, transpose)
    "attn_norm": ("model.layers.{li}.input_layernorm.weight", False),
    "wq": ("model.layers.{li}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{li}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{li}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{li}.self_attn.o_proj.weight", True),
    "mlp_norm": ("model.layers.{li}.post_attention_layernorm.weight", False),
    "w_gate": ("model.layers.{li}.mlp.gate_proj.weight", True),
    "w_up": ("model.layers.{li}.mlp.up_proj.weight", True),
    "w_down": ("model.layers.{li}.mlp.down_proj.weight", True),
}

# Mixtral naming: the dense MLP's three leaves give way to the router and
# the expert stacks (w1 = gate, w3 = up, w2 = down), indexed by {e}
_HF_MOE_LAYER = {
    **{k: v for k, v in _HF_LAYER.items() if k not in ("w_gate", "w_up", "w_down")},
    "router": ("model.layers.{li}.block_sparse_moe.gate.weight", True),
    "w_gate": ("model.layers.{li}.block_sparse_moe.experts.{e}.w1.weight", True),
    "w_up": ("model.layers.{li}.block_sparse_moe.experts.{e}.w3.weight", True),
    "w_down": ("model.layers.{li}.block_sparse_moe.experts.{e}.w2.weight", True),
}
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def load_llama_params(model_dir: str, config: LlamaConfig, quantize: Optional[str] = None,
                      device="cuda") -> Dict[str, Any]:
    """Load an HF llama-family checkpoint (a directory, or a cached repo id)
    into the models/llama.py tree on `device`. `quantize="int8"` stores
    projections, embedding and head as int8 leaves with per-channel f32
    scales. A .gguf path (file, or a directory holding one .gguf) takes
    the GGUF branch (load_llama_params_gguf)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    gg = _find_gguf(model_dir)
    if gg is not None:
        return load_llama_params_gguf(gg, config, quantize=quantize, device=device)
    r = _open_checkpoint(model_dir)
    if any("block_sparse_moe" in k or ".mlp.experts." in k for k in r.keys()):
        raise ValueError(f"{model_dir}: an MoE checkpoint; load it with load_moe_params "
                         "and an MoE model (--model mixtral-8x7b)")
    return _load_hf(r, config, _HF_LAYER, quantize, device)


def load_moe_params(model_dir: str, config, quantize: Optional[str] = None,
                    device="cuda") -> Dict[str, Any]:
    """Load an HF Mixtral-family checkpoint (block_sparse_moe.gate +
    experts.N.w1/w2/w3) into the models/moe.py tree on `device`.
    `quantize="int8"` covers the attention projections, embedding and head
    AND the expert stacks (per (layer, expert) out-channel scales, one
    matrix at a time); the f32 router stays f32. A .gguf path takes the
    GGUF branch (ffn_*_exps / ffn_gate_inp naming)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if not isinstance(config, MoeConfig):
        raise ValueError(f"load_moe_params needs an MoeConfig, got {type(config).__name__}")
    gg = _find_gguf(model_dir)
    if gg is not None:
        return load_llama_params_gguf(gg, config, quantize=quantize, device=device)
    return _load_hf(_open_checkpoint(model_dir), config, _HF_MOE_LAYER, quantize, device)


def _load_hf(r: _Checkpoint, config: LlamaConfig, layer_names: dict,
             quantize: Optional[str], device) -> Dict[str, Any]:
    """The tree of checkpoint `r` in the naming `layer_names` (tree key ->
    (HF name, transpose); a name with {e} is an expert stack)."""
    experts = config.num_experts if isinstance(config, MoeConfig) else 0
    fill = _Filler(config, quantize, device, r.get)
    params: Dict[str, Any] = {
        "layers": {key: fill.stacked(key, fmt, transpose, experts if "{e}" in fmt else 0)
                   for key, (fmt, transpose) in layer_names.items()},
        # per-ROW scale: rows gather as output vectors, and the transpose
        # doubles as the tied lm_head (quant.head_leaf)
        "embed": fill.single("model.embed_tokens.weight", quant=True, contract_axis=-1),
        "final_norm": fill.single("model.norm.weight", quant=False),
    }
    if config.tie_embeddings or "lm_head.weight" not in r:
        params["lm_head"] = None
    else:
        params["lm_head"] = fill.single("lm_head.weight", quant=True, transpose=True)
    return params


def save_llama_as_hf(params: Dict[str, Any], config: LlamaConfig, out_dir: str,
                     dtype: torch.dtype = torch.float32,
                     max_shard_bytes: Optional[int] = None) -> list:
    """Export a models/llama.py tree in HF naming. By default, as the
    reference does, one f32 `model.safetensors`; `dtype` and
    `max_shard_bytes` write it as HF publishes large checkpoints (e.g.
    BF16 shards behind `model.safetensors.index.json`). Leaves may live on
    any device: each tensor reaches the host only while it is written.
    Returns the file names."""
    return _save_hf(params, config, out_dir, _HF_LAYER, dtype, max_shard_bytes)


def save_moe_as_hf(params: Dict[str, Any], config, out_dir: str,
                   dtype: torch.dtype = torch.float32,
                   max_shard_bytes: Optional[int] = None) -> list:
    """Export a models/moe.py tree (unquantized) in Mixtral's HF naming, as
    `save_llama_as_hf` does; the router is written in `dtype` too."""
    return _save_hf(params, config, out_dir, _HF_MOE_LAYER, dtype, max_shard_bytes)


def _save_hf(params, config, out_dir, layer_names, dtype, max_shard_bytes) -> list:
    c = config
    os.makedirs(out_dir, exist_ok=True)
    L = params["layers"]
    tensors: Dict[str, torch.Tensor] = {"model.embed_tokens.weight": params["embed"]}
    for li in range(c.num_layers):
        for key, (fmt, transpose) in layer_names.items():
            for e in range(c.num_experts if "{e}" in fmt else 1):
                t = L[key][li, e] if "{e}" in fmt else L[key][li]
                tensors[fmt.format(li=li, e=e)] = t.t() if transpose else t
    tensors["model.norm.weight"] = params["final_norm"]
    if params.get("lm_head") is not None:
        tensors["lm_head.weight"] = params["lm_head"].t()
    if max_shard_bytes is None:
        save_file(tensors, os.path.join(out_dir, SINGLE_NAME), {"format": "pt"}, dtype)
        return [SINGLE_NAME]
    return save_sharded(tensors, out_dir, max_shard_bytes, dtype)


# --------------------------------------------------------------------- #
# GGUF checkpoints (llama.cpp naming): tensors load straight into the
# engine (llm/gguf.py load_tensor: f32 / f16 / q8_0).
# --------------------------------------------------------------------- #

def _find_gguf(path_or_repo: str) -> Optional[str]:
    """The .gguf file a path denotes, or None for the safetensors branch."""
    p = Path(os.path.expanduser(str(path_or_repo)))
    if p.suffix == ".gguf" and p.exists():
        return str(p)
    if p.is_dir():
        ggufs = sorted(p.glob("*.gguf"))
        if len(ggufs) == 1 and not (p / INDEX_NAME).exists() \
                and not list(p.glob("*.safetensors")):
            return str(ggufs[0])
    return None


_GGUF_LAYER_MAP = {
    # gguf name suffix -> (tree key, transpose): gguf stores each matrix
    # [out, in], the tree [in, out]
    "attn_norm.weight": ("attn_norm", False),
    "attn_q.weight": ("wq", True),
    "attn_k.weight": ("wk", True),
    "attn_v.weight": ("wv", True),
    "attn_output.weight": ("wo", True),
    "ffn_norm.weight": ("mlp_norm", False),
    "ffn_gate.weight": ("w_gate", True),
    "ffn_up.weight": ("w_up", True),
    "ffn_down.weight": ("w_down", True),
}

# MoE ggufs (llama.cpp naming): stacked expert tensors [E, out, in] and the
# router; "transpose" swaps the last two axes
_GGUF_MOE_LAYER_MAP = {
    **{k: v for k, v in _GGUF_LAYER_MAP.items()
       if k not in ("ffn_gate.weight", "ffn_up.weight", "ffn_down.weight")},
    "ffn_gate_inp.weight": ("router", True),
    "ffn_gate_exps.weight": ("w_gate", True),
    "ffn_up_exps.weight": ("w_up", True),
    "ffn_down_exps.weight": ("w_down", True),
}


_HF_WIDTHS = {"vocab_size": "vocab_size", "hidden_size": "hidden_size",
              "intermediate_size": "intermediate_size", "num_attention_heads": "num_heads",
              "num_key_value_heads": "num_kv_heads",
              # Mixtral's config.json
              "num_local_experts": "num_experts", "num_experts_per_tok": "num_experts_per_tok"}


def depth_from_hf(model_dir: str, config: LlamaConfig) -> LlamaConfig:
    """`config` with the depth an HF checkpoint's config.json gives
    (`num_hidden_layers`; the checkpoint may hold the model's first
    layers). The widths it states must be `config`'s. Without a
    config.json, `config` as it is."""
    path = Path(resolve_model_path(model_dir)) / "config.json"
    if not path.is_file():
        return config
    hf = json.loads(path.read_text())
    for key, field in _HF_WIDTHS.items():
        if key in hf and int(hf[key]) != getattr(config, field, hf[key]):
            raise ValueError(f"{path}: {key}={hf[key]}, the model has "
                             f"{field}={getattr(config, field)}")
    if "num_hidden_layers" not in hf:
        return config
    return dataclasses.replace(config, num_layers=int(hf["num_hidden_layers"]))


def config_from_gguf(path_or_content) -> LlamaConfig:
    """LlamaConfig (an MoeConfig for a file with `ffn_gate_inp` routers) from
    a .gguf file's metadata and tensor shapes (the checkpoint is
    authoritative; no registry entry needed). Accepts a path or an
    already-parsed GgufContent."""
    from ..llm.gguf import GgufContent, read_gguf

    g = (path_or_content if isinstance(path_or_content, GgufContent)
         else read_gguf(path_or_content, with_tensors=True))
    emb = g.tensors.get("token_embd.weight")
    if emb is None:
        raise ValueError(f"{g.path}: no token_embd.weight tensor")
    vocab, hidden = emb.shape
    is_moe = "blk.0.ffn_gate_inp.weight" in g.tensors
    # critical geometry must come from the file: silently defaulting
    # layers/heads would serve a truncated model as garbage tokens
    if not g.num_layers or not g.num_heads:
        raise ValueError(
            f"{g.path}: missing {g.architecture or '?'}.block_count / "
            f".attention.head_count metadata (architecture key "
            f"{g.metadata.get('general.architecture')!r})")
    heads = int(g.num_heads)
    meta = g.metadata
    arch = g.architecture or "llama"
    gate = g.tensors.get("blk.0.ffn_gate_exps.weight" if is_moe else "blk.0.ffn_gate.weight")
    cls, extra = LlamaConfig, {}
    if is_moe:
        n_exp = meta.get(f"{arch}.expert_count")
        n_used = meta.get(f"{arch}.expert_used_count")
        if not n_exp or not n_used:
            # silently defaulting top-k would route the wrong number of
            # experts and degrade output with no error anywhere
            raise ValueError(f"{g.path}: MoE gguf missing {arch}.expert_count / "
                             f".expert_used_count metadata")
        cls, extra = MoeConfig, dict(num_experts=int(n_exp), num_experts_per_tok=int(n_used))
    return cls(
        **extra,
        vocab_size=int(vocab),
        hidden_size=int(hidden),
        # [E, out, in] expert stacks, [out, in] dense matrices (numpy order)
        intermediate_size=int(gate.shape[-2]) if gate is not None else 4 * hidden,
        num_layers=int(g.num_layers),
        num_heads=heads,
        num_kv_heads=int(g.num_kv_heads or heads),
        head_dim=int(meta.get(f"{arch}.attention.key_length", hidden // heads)),
        rope_theta=float(meta.get(f"{arch}.rope.freq_base", 10000.0)),
        rms_norm_eps=float(meta.get(f"{arch}.attention.layer_norm_rms_epsilon", 1e-5)),
        max_position=int(g.context_length or 8192),
        tie_embeddings="output.weight" not in g.tensors,
    )


def save_llama_as_gguf(params: Dict[str, Any], config: LlamaConfig, path: str,
                       tensor_type: Optional[int] = None, tokens: Optional[list] = None,
                       name: str = "llama") -> None:
    """Export a models/llama.py (or unquantized models/moe.py) tree as a
    llama.cpp-named .gguf file (the metadata `config_from_gguf` reads
    back), every matrix in `tensor_type` (default q8_0; norms and an MoE
    router stay f32), with `tokens` as the embedded vocabulary (bos 1,
    eos 2). Each tensor reaches the host as f32 while it is encoded."""
    from ..llm.gguf import GGML_F32, GGML_Q8_0, write_gguf

    c = config
    ttype = GGML_Q8_0 if tensor_type is None else tensor_type
    meta: Dict[str, Any] = {
        "general.architecture": "llama", "general.name": name,
        "llama.block_count": c.num_layers, "llama.context_length": c.max_position,
        "llama.embedding_length": c.hidden_size, "llama.feed_forward_length": c.intermediate_size,
        "llama.attention.head_count": c.num_heads, "llama.attention.head_count_kv": c.num_kv_heads,
        "llama.attention.key_length": c.head_dim, "llama.rope.freq_base": float(c.rope_theta),
        "llama.attention.layer_norm_rms_epsilon": float(c.rms_norm_eps),
    }
    is_moe = isinstance(c, MoeConfig)
    if is_moe:
        meta.update({"llama.expert_count": c.num_experts,
                     "llama.expert_used_count": c.num_experts_per_tok})
    if tokens:
        meta.update({"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": list(tokens),
                     "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2})

    def host(t, transpose=False):
        t = t.transpose(-1, -2) if transpose else t
        return t.detach().to(device="cpu", dtype=torch.float32).contiguous().numpy()

    tensors: Dict[str, Any] = {"token_embd.weight": host(params["embed"])}
    types = {"token_embd.weight": ttype}
    for li in range(c.num_layers):
        for suffix, (key, transpose) in (_GGUF_MOE_LAYER_MAP if is_moe else _GGUF_LAYER_MAP).items():
            name_li = f"blk.{li}.{suffix}"
            tensors[name_li] = host(params["layers"][key][li], transpose)
            types[name_li] = ttype if transpose and key != "router" else GGML_F32
    tensors["output_norm.weight"] = host(params["final_norm"])
    if params.get("lm_head") is not None:
        tensors["output.weight"] = host(params["lm_head"], transpose=True)
        types["output.weight"] = ttype
    write_gguf(path, meta, tensors=tensors, tensor_types=types)


def load_llama_params_gguf(path, config: Optional[LlamaConfig] = None,
                           quantize: Optional[str] = None, device="cuda") -> Dict[str, Any]:
    """Load a .gguf llama-family checkpoint into the models/llama.py tree,
    or an MoE one (an MoeConfig) into the models/moe.py tree (each layer's
    `ffn_*_exps` tensor holds its E expert matrices). Tensors decode to f32
    on read (q8_0 included), then cast to the model dtype, or requantize
    per channel under quantize="int8" (GGUF's per-32-element q8_0 groups
    are not the engine's per-channel scheme); the router stays f32."""
    from ..llm.gguf import load_tensor, read_gguf

    g = read_gguf(path, with_tensors=True)
    c = config or config_from_gguf(g)
    layer_map = _GGUF_MOE_LAYER_MAP if isinstance(c, MoeConfig) else _GGUF_LAYER_MAP
    fill = _Filler(c, quantize, device, lambda name: torch.from_numpy(load_tensor(g, name)))
    params: Dict[str, Any] = {
        "layers": {key: fill.stacked(key, "blk.{li}." + suffix, transpose)
                   for suffix, (key, transpose) in layer_map.items()},
        "embed": fill.single("token_embd.weight", quant=True, contract_axis=-1),
        "final_norm": fill.single("output_norm.weight", quant=False),
    }
    if "output.weight" in g.tensors and not c.tie_embeddings:
        params["lm_head"] = fill.single("output.weight", quant=True, transpose=True)
    else:
        params["lm_head"] = None
    return params
