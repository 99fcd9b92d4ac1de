"""Parameters of the JAX reference as parameters of this port.

`params_from_jax` takes the reference's `init_params` pytree with every
leaf converted to a numpy array (stacked `layers` leaves `[L, in, out]`,
`lm_head=None` under tied embeddings) and returns the port's parameter
dictionary, which keeps the same tree and the same `[in, out]` weight
orientation. With it both packages compute on the same weights in tests.
Quantized leaves `{"q", "s"}` (the reference's `quantize_tree` output)
carry across as they are: `q` stays int8 and `s` f32, whatever `dtype`
the floating leaves are cast to. An MoE tree carries across the same way:
its expert stacks `[L, E, in, out]` (quantized: scales `[L, E, 1, out]`)
like any layer leaf, and its router stays f32 whatever `dtype` is, as the
reference keeps it. `adapter_from_jax` does the same for a reference LoRA
adapter, and `vit_params_from_jax` for the reference's ViT tree.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _leaf(a, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind not in "fiu":  # e.g. ml_dtypes bfloat16: widen first
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, order="C", copy=True))  # own its memory
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def _any_leaf(a, dtype: Optional[torch.dtype], device):
    if isinstance(a, dict) and "q" in a and "s" in a:  # quantized: keep int8 + f32
        return {"q": _leaf(a["q"], torch.int8, device),
                "s": _leaf(a["s"], torch.float32, device)}
    return _leaf(a, dtype, device)


def params_from_jax(tree: Dict[str, Any], dtype: Optional[torch.dtype] = None,
                    device="cuda") -> Dict[str, Any]:
    """numpy pytree of the reference -> the port's parameters on `device`
    (floating leaves cast to `dtype` when given)."""
    return {
        "embed": _any_leaf(tree["embed"], dtype, device),
        # the MoE router stays f32 (routing decisions are numerically sensitive)
        "layers": {k: _any_leaf(v, torch.float32 if k == "router" else dtype, device)
                   for k, v in tree["layers"].items()},
        "final_norm": _leaf(tree["final_norm"], dtype, device),
        "lm_head": None if tree.get("lm_head") is None
        else _any_leaf(tree["lm_head"], dtype, device),
    }


def adapter_from_jax(adapter, dtype: Optional[torch.dtype] = None, device="cpu"):
    """A reference `LoraAdapter` (its A/B arrays as numpy or JAX arrays) ->
    the port's `models.lora.LoraAdapter`, each tensor on `device` in `dtype`
    (default: the array's own type; a bfloat16 array arrives as f32)."""
    from .lora import LoraAdapter

    return LoraAdapter(
        name=adapter.name, rank=int(adapter.rank), scale=float(adapter.scale),
        a={t: _leaf(v, dtype, device) for t, v in adapter.a.items()},
        b={t: _leaf(v, dtype, device) for t, v in adapter.b.items()},
    )


def vit_params_from_jax(tree: Dict[str, Any], dtype: Optional[torch.dtype] = None,
                        device="cpu") -> Dict[str, Any]:
    """The reference's ViT tree (`dynamo_tpu.models.vit.init_params`, its
    leaves numpy or JAX arrays) as the port's `models.vit` tree: the same
    nesting (a list of layer dicts), every leaf a tensor on `device`."""
    if isinstance(tree, dict):
        return {k: vit_params_from_jax(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [vit_params_from_jax(v, dtype, device) for v in tree]
    return _leaf(tree, dtype, device)
