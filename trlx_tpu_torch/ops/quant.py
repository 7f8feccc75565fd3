"""Int8 KV-cache quantization (symmetric, per token per kv head).

Port of `quantize_kv` / `dequantize_kv` from the JAX package's
`ops/quant.py`. Rounding is half-to-even on both sides (`jnp.round` and
`torch.round` agree), so the int8 codes are bit-equal to the JAX ones
for the same f32 input. The frozen-trunk weight quantization of that
module waits for the rollout slice.
"""

import torch


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
