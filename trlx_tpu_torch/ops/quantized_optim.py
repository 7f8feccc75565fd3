"""8-bit optimizer states (the reference's bitsandbytes `Adam8bit` role),
the port's copy of the JAX package's `ops/quantized_optim.py`.

Adam's m and v moments are stored block-wise quantized to int8 with one
f32 absmax scale per block of 256: about 4x less optimizer-state memory
per moment. The quantize and dequantize run around the plain Adam math in
each step (plain torch, as they are plain XLA in the JAX package; a
fused kernel is later performance work).

Where bitsandbytes uses a nonlinear dynamic code to cover the second
moment's dynamic range, v is quantized in sqrt space: the ratio between a
block's largest and smallest sqrt(v) is the gradient ratio (not its
square), so elements whose gradients are 100x below the block max still
get nonzero codes. Tensors smaller than one block (biases, norm scales)
are stored exact in f32, with a size-1 scale placeholder.
"""

from typing import Iterable, Tuple

import torch

BLOCK = 256


def block_quantize(x: torch.Tensor, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 codes [n_blocks, block], f32 scales
    [n_blocks]): absmax / 127 a block, codes rounded half to even (as
    `jnp.round`), in a zero-padded flat layout whose shape
    `block_dequantize` restores. A tensor under one block passes through
    exact (f32 codes, a zero scale of size 1)."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    if n < block:
        return flat.clone(), torch.zeros((1,), dtype=torch.float32, device=x.device)
    n_blocks = -(-n // block)
    padded = torch.zeros((n_blocks * block,), dtype=torch.float32, device=x.device)
    padded[:n] = flat
    blocks = padded.reshape(n_blocks, block)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127).to(torch.int8)
    return q, scale


def block_dequantize(q: torch.Tensor, scale: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    if q.dtype != torch.int8:  # exact small-tensor passthrough
        return q.reshape(shape)
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= int(s)
    return flat[:n].reshape(shape)


class Adam8bit(torch.optim.Optimizer):
    """Adam over int8 block-quantized moments (m linear-coded, v coded in
    sqrt space), with optax's chain order: the Adam scaling, then (for
    AdamW) `weight_decay * p` added to the update, then the learning
    rate, `p += -lr * update`. Its state, per parameter, is `step` and
    the codes and scales `m_q`, `m_scale`, `v_q`, `v_scale`; the
    `state_dict` round-trips them for an exact resume.

    The lr follows the port's convention: the trainer builds it at 1.0
    and a `LambdaLR` sets each step's value from the schedule."""

    def __init__(self, params: Iterable, lr: float = 1.0, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd, lr = group["eps"], group["weight_decay"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    state["step"] = 0
                    state["m_q"], state["m_scale"] = block_quantize(zeros)
                    state["v_q"], state["v_scale"] = block_quantize(zeros)
                state["step"] += 1
                count = torch.tensor(float(state["step"]), dtype=torch.float32, device=p.device)
                m = block_dequantize(state["m_q"], state["m_scale"], p.shape)
                v = torch.square(block_dequantize(state["v_q"], state["v_scale"], p.shape))
                g = p.grad.float()
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                m_hat = m / (1 - torch.tensor(b1, dtype=torch.float32, device=p.device) ** count)
                v_hat = v / (1 - torch.tensor(b2, dtype=torch.float32, device=p.device) ** count)
                upd = (m_hat / (torch.sqrt(v_hat) + eps)).to(p.dtype)
                if wd:
                    upd = upd + wd * p
                p.add_(upd * -lr)
                state["m_q"], state["m_scale"] = block_quantize(m)
                state["v_q"], state["v_scale"] = block_quantize(torch.sqrt(v))
        return loss

    def load_state_dict(self, state_dict):
        """torch's loader casts every state tensor of a floating-point
        parameter to that parameter's dtype: the int8 codes and the f32
        scales get their own dtypes back."""
        super().load_state_dict(state_dict)
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for i, p in zip(ids, params):
            for k, v in state_dict["state"].get(i, {}).items():
                if torch.is_tensor(v):
                    self.state[p][k] = v.to(device=p.device).clone()


def opt_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of every tensor in an optimizer's state."""
    return sum(v.numel() * v.element_size() for s in optimizer.state.values() for v in s.values()
               if torch.is_tensor(v))
