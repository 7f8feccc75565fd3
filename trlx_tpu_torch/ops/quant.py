"""Int8 quantization: the KV cache (symmetric, per token per kv head) and
the frozen trunk's decode weights (symmetric, per channel).

Port of the JAX package's `ops/quant.py`. Rounding is half-to-even on
both sides (`jnp.round` and `torch.round` agree) and the scale is the
same f32 `amax / 127`, so the int8 codes are bit-equal to the JAX ones
for the same f32 input.

The frozen-trunk view (`method.quantize_frozen_trunk`): under a hydra
split the weight matrices of blocks [0, split), the token embedding and
the learned position table never train, so they are held as int8 with a
per-channel f32 scale and swapped in for generation only; training and
scoring always read the dense parameters. JAX keeps a quantized leaf as
a `{"q", "scale"}` node of its parameter tree; the port keeps the
quantized leaves as `{parameter name: (q int8, scale f32)}` beside the
module, and the sampler dequantizes them (`dequantize_tree`) into the
compute dtype once per call, then runs the module with those tensors in
place of its parameters (`utils.modeling.swapped_params`). The scale
keeps the reduced axes as size 1, so `q * scale` broadcasts without an
axis argument.
"""

from typing import Dict, Tuple

import torch
from torch import nn


def quantize_kv(x: torch.Tensor):
    """Symmetric per-token-per-head int8 for KV-cache blocks: the scale
    axis is the head dim (last), so each written token keeps its own f32
    scale per kv head. Returns (q int8 [..., hd], scale f32 [...])."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of `quantize_kv`: q * scale in f32, cast to `dtype`."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def is_quant_leaf(node) -> bool:
    """True for the (q int8, scale f32) pairs `quantize_array` returns."""
    return (isinstance(node, tuple) and len(node) == 2 and torch.is_tensor(node[0])
            and node[0].dtype == torch.int8)


def quantize_array(w: torch.Tensor, channel_dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8, one f32 scale per index of
    `channel_dim` (the amax runs over every other axis). The JAX package
    takes channels along the last axis of its layout: a Dense kernel's
    output features ([in, out]; dim 0 of the port's [out, in] Linear
    weight), an embedding's features ([V, d]) and an expert weight's
    output features ([E, d, f] or [E, f, d]; the last axis in both).
    Returns (q int8 shaped like w, scale f32 with the reduced axes kept
    as size 1)."""
    w32 = w.detach().to(torch.float32)
    dim = channel_dim % w32.dim()
    reduce = [a for a in range(w32.dim()) if a != dim]
    amax = w32.abs().amax(dim=reduce, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_array(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q * scale back to f32 (the modules cast to the compute dtype at
    use, as they do the f32 parameters)."""
    return q.to(torch.float32) * scale


def frozen_decode_names(model: nn.Module, split: int):
    """The parameters the int8 decode view replaces: float matrices
    (ndim >= 2) of `lm.block_{i}` for i < split, `lm.embed_tokens` and
    `lm.embed_pos`. Norms, biases and an untied head stay dense."""
    frozen = {f"block_{i}" for i in range(split)} | {"embed_tokens", "embed_pos"}
    return [name for name, p in model.named_parameters()
            if name.split(".")[:1] == ["lm"] and name.split(".")[1] in frozen
            and p.dim() >= 2 and p.is_floating_point()]


def quantize_frozen(model: nn.Module, split: int) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The frozen trunk's int8 leaves, `{parameter name: (q, scale)}`
    (the JAX `quantize_decode_params` / `quantize_frozen_flat`): built
    once, since those parameters never train; every other parameter the
    sampler reads is the module's live one."""
    from trlx_tpu_torch.models.transformer import Linear  # that module imports this one

    if split <= 0:
        raise ValueError("quantize_frozen requires a hydra split > 0")
    params = dict(model.named_parameters())
    # a Linear weight is the JAX kernel transposed, so its output channel
    # is dim 0; every other leaf keeps the JAX layout (embeddings [V, d],
    # the experts' [E, d, f] and [E, f, d]), channels last
    transposed = {f"{name}.weight" for name, m in model.named_modules() if isinstance(m, Linear)}
    return {name: quantize_array(params[name], 0 if name in transposed else -1)
            for name in frozen_decode_names(model, split)}


def dequantize_tree(view: Dict, dtype) -> Dict[str, torch.Tensor]:
    """A decode view -> dense tensors: each (q, scale) leaf becomes
    `q * scale` in f32 cast to `dtype` (bitwise what the module's own
    cast of an f32 parameter gives), dense leaves pass through."""
    return {name: dequantize_array(*leaf).to(dtype) if is_quant_leaf(leaf) else leaf
            for name, leaf in view.items()}


def quantized_bytes(view: Dict) -> int:
    """Device bytes of a decode view's leaves (int8 q plus f32 scales)."""
    return sum(t.numel() * t.element_size() for leaf in view.values()
               for t in (leaf if is_quant_leaf(leaf) else (leaf,)))
