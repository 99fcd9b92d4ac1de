"""Vision Transformer encoder in PyTorch: the E of multimodal E/P/D.

Port of `dynamo_tpu/models/vit.py`. The architecture is HF `ViTModel`'s
(CLS token, learned position embeddings, pre-LN blocks, exact-GELU MLP,
final LayerNorm), so HF exports load directly; a LLaVA-style two-layer
projector maps the patch tokens to the LLM's hidden width for the
engine's prefill splice (engine/engine.py, `emb_override` of
`models/llama.prefill_forward_batched`).

The reference's rounding points are kept: the patch embed is one product
over flattened (C, P, P) patches, attention is two plain products with the
softmax in f32 and cast to the model dtype before the second, LayerNorm
uses the population variance. The encoder runs in f32 (`ViTConfig.dtype`);
on a CUDA device its products need TF32 off (torch's default
`float32_matmul_precision` "highest"), or the card's encoder drifts from
the CPU's by more than f32 rounding — `llm/multimodal.ViTEncoder` checks.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict

import torch
import torch.nn.functional as F

PROJ_SEED = 0  # seed of the projector drawn when a checkpoint carries none


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    out_hidden: int = 768  # LLM hidden width the projector emits
    dtype: Any = torch.float32

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **overrides):
        """CPU-test scale (mirrors LlamaConfig.tiny)."""
        kw = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                  num_heads=4, intermediate_size=128, out_hidden=64)
        kw.update(overrides)
        return cls(**kw)


def _dense(c: ViTConfig, generator: torch.Generator, shape, scale: float = 0.02):
    w = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (w * scale).to(c.dtype)


def _init_proj(c: ViTConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The projector's random draw (w1, then w2, N(0, 0.02); zero biases),
    shared by `init_params` and the checkpoint loader, which draws it only
    when the export carries no projector."""
    dev = generator.device
    return {
        "w1": _dense(c, generator, (c.hidden_size, c.out_hidden)),
        "b1": torch.zeros((c.out_hidden,), dtype=c.dtype, device=dev),
        "w2": _dense(c, generator, (c.out_hidden, c.out_hidden)),
        "b2": torch.zeros((c.out_hidden,), dtype=c.dtype, device=dev),
    }


def _norm(c: ViTConfig, dev) -> Dict[str, torch.Tensor]:
    return {"w": torch.ones((c.hidden_size,), dtype=c.dtype, device=dev),
            "b": torch.zeros((c.hidden_size,), dtype=c.dtype, device=dev)}


def init_params(config: ViTConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random-init tree of the reference's shape (the shape
    `params_from_hf_state` fills), drawn from `generator` on its own device
    in this order: patch_w, cls, pos, each layer's wq, wk, wv, wo, w_up,
    w_down, then the projector's w1, w2 (all N(0, 0.02) in f32, cast);
    norms are ones, biases zeros. The leaves then move to `device` (default:
    the generator's), so a CPU generator gives the same weights anywhere."""
    c = config
    dev = generator.device
    H, I = c.hidden_size, c.intermediate_size
    zeros = lambda n: torch.zeros((n,), dtype=c.dtype, device=dev)  # noqa: E731
    params: Dict[str, Any] = {
        "patch_w": _dense(c, generator, (c.num_channels * c.patch_size ** 2, H)),
        "patch_b": zeros(H),
        "cls": _dense(c, generator, (1, 1, H)),
        "pos": _dense(c, generator, (1, c.n_patches + 1, H)),
        "layers": [],
        "ln_f": _norm(c, dev),
    }
    for _ in range(c.num_layers):
        params["layers"].append({
            "ln1": _norm(c, dev),
            "wq": _dense(c, generator, (H, H)), "bq": zeros(H),
            "wk": _dense(c, generator, (H, H)), "bk": zeros(H),
            "wv": _dense(c, generator, (H, H)), "bv": zeros(H),
            "wo": _dense(c, generator, (H, H)), "bo": zeros(H),
            "ln2": _norm(c, dev),
            "w_up": _dense(c, generator, (H, I)), "b_up": zeros(I),
            "w_down": _dense(c, generator, (I, H)), "b_down": zeros(H),
        })
    params["proj"] = _init_proj(c, generator)
    return to_device(params, device) if device is not None else params


def to_device(tree, device):
    """The tree with every tensor on `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def _ln(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)  # population variance
    return (x - mu) / torch.sqrt(var + eps) * p["w"] + p["b"]


def forward(params: Dict[str, Any], config: ViTConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, C, H, W] (HF layout) -> last hidden state
    [B, n_patches + 1, hidden] (CLS first), after the final LayerNorm:
    HF `ViTModel.last_hidden_state`."""
    c = config
    B = pixels.shape[0]
    P, nc = c.patch_size, c.num_channels
    n_side = c.image_size // P
    # [B, C, H, W] -> [B, n_side, n_side, C, P, P] -> [B, N, C*P*P]
    x = pixels.reshape(B, nc, n_side, P, n_side, P)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, n_side * n_side, nc * P * P)
    x = x.to(c.dtype) @ params["patch_w"] + params["patch_b"]
    cls = params["cls"].expand(B, 1, c.hidden_size).to(c.dtype)
    x = torch.cat([cls, x], dim=1) + params["pos"]

    H, D = c.num_heads, c.head_dim
    T = x.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=c.dtype, device=x.device))
    for lyr in params["layers"]:
        h = _ln(x, lyr["ln1"], c.layer_norm_eps)
        q = (h @ lyr["wq"] + lyr["bq"]).reshape(B, T, H, D)
        k = (h @ lyr["wk"] + lyr["bk"]).reshape(B, T, H, D)
        v = (h @ lyr["wv"] + lyr["bv"]).reshape(B, T, H, D)
        att = torch.einsum("bthd,bshd->bhts", q, k) * scale
        att = torch.softmax(att.float(), dim=-1).to(c.dtype)
        o = torch.einsum("bhts,bshd->bthd", att, v).reshape(B, T, H * D)
        x = x + (o @ lyr["wo"] + lyr["bo"])
        h = _ln(x, lyr["ln2"], c.layer_norm_eps)
        h = F.gelu(h @ lyr["w_up"] + lyr["b_up"], approximate="none")
        x = x + (h @ lyr["w_down"] + lyr["b_down"])
    return _ln(x, params["ln_f"], c.layer_norm_eps)


def encode_tokens(params: Dict[str, Any], config: ViTConfig, pixels: torch.Tensor) -> torch.Tensor:
    """The whole encoder: ViT, CLS dropped, projector. [B, C, H, W] ->
    [B, n_patches, out_hidden]: the rows the engine splices over the
    placeholder positions."""
    h = forward(params, config, pixels)[:, 1:]
    p = params["proj"]
    h = F.gelu(h @ p["w1"] + p["b1"], approximate="none")
    return h @ p["w2"] + p["b2"]


# --------------------------------------------------------------------- #
# HF checkpoints
# --------------------------------------------------------------------- #

def params_from_hf_state(state: Dict[str, Any], config: ViTConfig, prefix: str = "",
                         device="cpu") -> Dict[str, Any]:
    """An HF `ViTModel` state dict (torch tensors or numpy arrays) as the
    `init_params` tree on `device`. `prefix` is the nesting of the export
    ("vit." for `ViTForImageClassification`). The projector is not part of
    HF ViT: keys `proj.w1` / `proj.b1` / `proj.w2` / `proj.b2` are taken
    when present, and every missing one is drawn as `_init_proj` draws it
    from a CPU `torch.Generator` seeded with PROJ_SEED (0)."""
    c = config

    def get(name):
        return torch.as_tensor(state[prefix + name]).to(device=device, dtype=c.dtype)

    conv_w = get("embeddings.patch_embeddings.projection.weight")
    # Conv2d [hidden, C, P, P] -> a product [(C, P, P) flat, hidden]: the
    # flattening order of forward()'s (C, ph, pw) patches
    params: Dict[str, Any] = {
        "patch_w": conv_w.reshape(c.hidden_size, -1).t().contiguous(),
        "patch_b": get("embeddings.patch_embeddings.projection.bias"),
        "cls": get("embeddings.cls_token"),
        "pos": get("embeddings.position_embeddings"),
        "layers": [],
        "ln_f": {"w": get("layernorm.weight"), "b": get("layernorm.bias")},
    }
    for i in range(c.num_layers):
        p = f"encoder.layer.{i}."
        lin = lambda n: get(p + n + ".weight").t().contiguous()  # noqa: E731
        bias = lambda n: get(p + n + ".bias")  # noqa: E731
        params["layers"].append({
            "ln1": {"w": get(p + "layernorm_before.weight"),
                    "b": get(p + "layernorm_before.bias")},
            "wq": lin("attention.attention.query"), "bq": bias("attention.attention.query"),
            "wk": lin("attention.attention.key"), "bk": bias("attention.attention.key"),
            "wv": lin("attention.attention.value"), "bv": bias("attention.attention.value"),
            "wo": lin("attention.output.dense"), "bo": bias("attention.output.dense"),
            "ln2": {"w": get(p + "layernorm_after.weight"),
                    "b": get(p + "layernorm_after.bias")},
            "w_up": lin("intermediate.dense"), "b_up": bias("intermediate.dense"),
            "w_down": lin("output.dense"), "b_down": bias("output.dense"),
        })
    # only the four projector arrays are drawn, never a whole init_params
    proj = to_device(_init_proj(c, torch.Generator().manual_seed(PROJ_SEED)), device)
    for name in ("w1", "b1", "w2", "b2"):
        if prefix + "proj." + name in state:
            proj[name] = get("proj." + name)
    params["proj"] = proj
    return params


def load_vit_params(model_dir: str, config: ViTConfig, device="cpu") -> Dict[str, Any]:
    """An HF ViT export (`*.safetensors`, else `*.bin`) from a local
    directory. The "vit." prefix is taken when any key carries it."""
    from .safetensors_io import SafetensorsFile

    d = Path(model_dir)
    state: Dict[str, Any] = {}
    sts = sorted(d.glob("*.safetensors"))
    if sts:
        for f in sts:
            st = SafetensorsFile(f)
            state.update({k: st.get(k) for k in st.keys()})
    else:
        bins = sorted(d.glob("*.bin"))
        if not bins:
            raise FileNotFoundError(f"no ViT weights under {model_dir}")
        for f in bins:
            state.update(torch.load(str(f), map_location="cpu", weights_only=True))
    prefix = "vit." if any(k.startswith("vit.") for k in state) else ""
    return params_from_hf_state(state, config, prefix=prefix, device=device)
