"""Decoder-only transformer LM (PyTorch).

Port of the JAX package's `models/transformer.py`: `TransformerConfig`,
`PRESETS`, `TransformerLM` with `embed`/`unembed`, the training/scoring
forward (`forward`, dense causal bias or the flash kernels under
`attn_impl="flash"`; `forward_window`, the head over a window only), the
trunk-cache pair (`forward_trunk`, the embeddings and the frozen blocks;
`forward_from_captures` / `forward_from_window`, the rest resumed from
their output; `forward_captures` and `forward_from_captures` also keep
the deeper value branch's input), the fixed-slot dense KV cache (`init_kv_cache`,
`decode_step`) that the sampler uses, with per-row offsets for the
speculative sampler's `spec_draft_step` (the trunk alone) and
`spec_verify_rows` (the suffix over all drafted positions at once), and
the per-row cached `prefill_rows` and `decode_step_rows` over a paged KV
arena (`init_paged_kv_arena`) that the inference engine uses. Families: GPT-2
(learned positions, LayerNorm, tanh-gelu, tied embeddings), the llama
knobs (rope, RMSNorm, silu-glu, GQA/MQA, untied head, no biases) and
Mistral's sliding window, GPT-NeoX/pythia (partial rotary, parallel
residual), GPT-J (the parallel residual's shared norm, no attention
biases, a biased head), OPT (positions read at an offset of 2), Bloom
(ALiBi, a norm after the embedding, no position embedding) and
GPTBigCode (MQA). Under `moe_experts > 0` every block's MLP is the
mixture of experts (`MoEMLP`, dense dispatch), whose load-balancing terms
a `collect_moe_aux` block gathers for the losses.

Adapters (`models/lora.py`): a `Linear` named in `cfg.lora_targets` adds
its LoRA delta, every attention sees `cfg.prefix_tokens` trainable keys
and values (the dense-bias path only), and the LM prepends
`cfg.prompt_tokens` trainable embeddings (the training forward slices
them off before the head; the cached prefill writes them into the
cache's first columns, which `init_kv_cache` reserves). The no-cache
forwards take `adapters=False`, the base model alone (the reference under
adapters); the slot-pool paths refuse prompt and prefix tuning, as JAX
does. Multi-tenant serving hands per-row factor pairs to the `Linear`s
through a `lora_rows` block (one pair a batch row, each row's own
tenant), which replace each module's own pair for the calls made inside
it, in this thread only.

ALiBi and an active sliding window need the dense bias: the flash kernels
(`fused_attention_ok`) and the paged decode kernel express plain causal
attention only, as the Pallas kernels do, so those configurations take
the einsum path; a window no shorter than the sequence keeps the kernels.

Numerics follow the flax layers: parameters are f32 and cast to
`cfg.dtype` at use (a `Dense` with `param_dtype=f32, dtype=bf16`),
norms take their statistics in f32, attention scores and softmax are
f32, and masked columns carry a -1e9 additive bias whose exp is exactly
0.0.

The KV arena is updated IN PLACE (the JAX package scattered functionally
into a donated pool). JAX silently drops a scatter to block index
`n_blocks`; torch indexing would raise instead, so `init_paged_kv_arena`
allocates one spare block at index `n_blocks` that no block table names,
and every write the JAX code would drop (right pad, inactive slots,
padding rows with all-out-of-range tables) is redirected there
explicitly.
"""

import contextvars
import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.ops import quant


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    n_kv_heads: Optional[int] = None  # GQA/MQA; None = n_heads
    max_seq_len: int = 2048
    pos_embed: str = "learned"  # "learned" | "rope" | "none"
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    activation: str = "gelu"  # "gelu" (tanh approx) | "gelu_exact" | "silu" | "relu"
    glu: bool = False
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    layer_norm_epsilon: float = 1e-5
    use_bias: bool = True
    parallel_residual: bool = False  # h + attn(ln(h)) + mlp(·) (GPT-NeoX/GPT-J)
    shared_ln: bool = False  # the parallel MLP reads ln_attn's output (GPT-J): no ln_mlp
    rotary_pct: float = 1.0  # share of head_dim that rotates (pythia 0.25)
    alibi: bool = False  # ALiBi key-position bias (Bloom)
    pos_offset: int = 0  # learned positions read at positions + offset (OPT: 2)
    embed_ln: bool = False  # a norm right after the embedding (Bloom)
    attn_bias: Optional[bool] = None  # q/k/v/o bias; None = use_bias (GPT-J: False)
    lm_head_bias: bool = False  # an untied head with a bias (GPT-J)
    sliding_window: Optional[int] = None  # banded causal attention (Mistral)
    # the MoE MLP (`MoEMLP`): `moe_experts` > 0 experts, top-`moe_top_k`
    # routing, and the load-balancing term's coefficient in the losses
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_aux_coef: float = 0.01
    hf_family: Optional[str] = None
    # adapters (`models/lora.py`): LoRA of rank `lora_rank` on the
    # projections named in `lora_targets`; `prompt_tokens` trainable
    # embeddings prepended to every sequence; `prefix_tokens` trainable
    # keys and values in every attention (the dense-bias path only)
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("q_proj", "v_proj")
    prompt_tokens: int = 0
    prefix_tokens: int = 0
    dtype: Any = torch.bfloat16  # activation/compute dtype
    param_dtype: Any = torch.float32
    remat_blocks: bool = False
    attn_impl: str = "xla"

    def __post_init__(self):
        if self.moe_experts > 0 and self.lora_rank > 0:
            raise NotImplementedError(
                "LoRA adapters on MoE expert weights are not supported; set moe_experts=0 or lora_rank=0"
            )
        if self.prefix_tokens > 0 and self.attn_impl != "xla":
            raise NotImplementedError("prefix tuning needs the dense-bias attention path; set attn_impl='xla'")
        check_supported(self)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def rotary_dim(self) -> int:
        rd = int(self.head_dim * self.rotary_pct)
        return rd - (rd % 2)


def check_supported(cfg: TransformerConfig) -> None:
    """Refuse the knobs this port does not run yet, naming the ROADMAP
    item that brings them."""
    if cfg.attn_impl not in ("xla", "flash"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} (ring/blockwise attention) is not ported yet "
            "(ROADMAP queue A, item 4: parallelism)"
        )


def fused_attention_ok(cfg: TransformerConfig, seq_len: Optional[int] = None) -> bool:
    """Whether the flash kernels express cfg's attention structure (plain
    causal plus key padding) for a length-`seq_len` forward. The single
    source of truth for Attention's branch and `train_bias`: the bias is
    None exactly when the kernel builds the structure itself. ALiBi never
    fits; a sliding window is a no-op when seq_len <= window, so such a
    forward keeps the kernels (Mistral's 4096 window at shorter lengths)."""
    if cfg.attn_impl != "flash" or cfg.alibi:
        return False
    return cfg.sliding_window is None or (seq_len is not None and seq_len <= cfg.sliding_window)


def activation_fn(cfg: TransformerConfig):
    """cfg.activation -> callable; jax.nn.gelu's default is the tanh form."""
    return {
        "silu": F.silu,
        "relu": F.relu,
        "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    }.get(cfg.activation, lambda x: F.gelu(x, approximate="tanh"))


def _normal_(t: torch.Tensor, std: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


# per-row LoRA factors of multi-tenant serving, {Linear: (a [b, in, r],
# b [b, r, out])}, while a `lora_rows` block is open in this thread
_LORA_ROWS: contextvars.ContextVar = contextvars.ContextVar("lora_rows", default=None)


@contextmanager
def lora_rows(factors: Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]]):
    """Per-row LoRA factors for the calls made inside the block, in this
    thread only (the JAX package's `lora_rows` variable collection): each
    `Linear` in `factors` applies row i's pair to batch row i in place of
    its own `lora_a` / `lora_b`. Scoped to the thread so a server thread
    decoding on a trainer's module never leaks a tenant's factors into a
    training forward that runs beside it."""
    token = _LORA_ROWS.set(factors)
    try:
        yield
    finally:
        _LORA_ROWS.reset(token)


class Linear(nn.Module):
    """flax `nn.Dense(param_dtype=f32, dtype=cfg.dtype)`: weight [out, in]
    (the JAX kernel transposed), input, weight and bias cast to the compute
    dtype at use. With `lora_rank > 0` (the JAX `lora_dense`) it also owns
    `lora_a` [in, r] (normal, std 1/r) and `lora_b` [r, out] (zeros), the
    JAX leaves in their own orientation, and adds `lora_delta(x)` unless
    the call passes `adapters=False`; inside a `lora_rows` block that
    names it, the per-row pair replaces its own."""

    def __init__(self, in_features: int, out_features: int, bias: bool, dtype, param_dtype,
                 device=None, generator=None, lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype, device=device))
        _normal_(self.weight, 1.0 / math.sqrt(in_features), generator)
        self.bias = (
            nn.Parameter(torch.zeros(out_features, dtype=param_dtype, device=device)) if bias else None
        )
        self.lora_rank = lora_rank
        if lora_rank > 0:
            self.lora_scale = lora_alpha / lora_rank
            self.lora_a = nn.Parameter(torch.empty(in_features, lora_rank, dtype=param_dtype, device=device))
            _normal_(self.lora_a, 1.0 / lora_rank, generator)
            self.lora_b = nn.Parameter(torch.zeros(lora_rank, out_features, dtype=param_dtype, device=device))

    def forward(self, x, adapters: bool = True):
        dt = self.dtype
        y = F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))
        if self.lora_rank > 0 and adapters:
            rows = _LORA_ROWS.get()
            pair = None if rows is None else rows.get(self)
            y = y + (self.lora_delta(x) if pair is None else self.lora_delta_rows(x, *pair))
        return y

    def lora_delta(self, x):
        """((x A) B) alpha / r in the compute dtype."""
        dt = self.dtype
        return ((x.to(dt) @ self.lora_a.to(dt)) @ self.lora_b.to(dt)) * self.lora_scale

    def lora_delta_rows(self, x, a_rows, b_rows):
        """The delta with row i's own pair (a_rows [b, in, r], b_rows
        [b, r, out]), as the JAX `lora_dense`'s two einsums; a zero pair
        adds exactly 0.0."""
        dt = self.dtype
        xr = torch.einsum("b...d,bdr->b...r", x.to(dt), a_rows.to(dt))
        return torch.einsum("b...r,brf->b...f", xr, b_rows.to(dt)) * self.lora_scale


def make_linear(cfg: "TransformerConfig", name: str, in_features: int, out_features: int, bias: bool,
                device=None, generator=None) -> Linear:
    """A projection of a block, named as in the JAX tree (`q_proj`, ...,
    `down_proj`), with a LoRA pair when its name is a LoRA target."""
    rank = cfg.lora_rank if name in cfg.lora_targets else 0
    return Linear(in_features, out_features, bias, cfg.dtype, cfg.param_dtype, device, generator,
                  lora_rank=rank, lora_alpha=cfg.lora_alpha)


class LayerNorm(nn.Module):
    """flax LayerNorm: statistics and affine in f32, output in cfg.dtype."""

    def __init__(self, d: int, eps: float, dtype, param_dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(d, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=param_dtype, device=device))

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.dtype)


class RMSNorm(nn.Module):
    """flax RMSNorm: mean square in f32, output in cfg.dtype."""

    def __init__(self, d: int, eps: float, dtype, param_dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(d, dtype=param_dtype, device=device))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(self.dtype)


def make_norm(cfg: TransformerConfig, device=None) -> nn.Module:
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype, cfg.param_dtype, device)


class Embed(nn.Module):
    """flax `nn.Embed`: lookup and the tied `attend` (h @ E.T), both in
    cfg.dtype."""

    def __init__(self, num: int, d: int, dtype, param_dtype, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, d, dtype=param_dtype, device=device))
        _normal_(self.weight, 1.0 / math.sqrt(d), generator)

    def forward(self, ids):
        return self.weight[ids].to(self.dtype)

    def attend(self, h):
        return h.to(self.dtype) @ self.weight.to(self.dtype).T


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """Rotary position embedding (half-split / rotate_half convention).
    x: [b, t, h, hd], positions: [b, t]. With rotary_dim < hd only the
    first rotary_dim dims rotate (pythia/GPT-J partial rotary; GPT-J's
    interleaved checkpoints are permuted to this layout at load)."""
    hd = x.shape[-1]
    rd = hd if rotary_dim is None else rotary_dim
    rot = x if rd == hd else x[..., :rd]
    freqs = torch.from_numpy(np.asarray(rope_frequencies(rd, theta), np.float32))
    angles = positions[..., None].float() * freqs.to(x.device)  # [b, t, rd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = rot.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return rotated if rd == hd else torch.cat([rotated, x[..., rd:]], dim=-1)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes (Press et al.; as HF Bloom builds them)."""

    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return np.asarray(pow2(n_heads), dtype=np.float32)
    closest = 2 ** math.floor(math.log2(n_heads))
    extra = pow2(2 * closest)[0::2][: n_heads - closest]
    return np.asarray(pow2(closest) + extra, dtype=np.float32)


def alibi_bias(key_mask: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Additive ALiBi bias [b, h, 1, S] f32 from the key validity mask [b,
    S]: slope * k_pos with k_pos the key's position among the row's valid
    keys (0 on padding), HF Bloom's cumsum form; the per-query constant of
    the relative form cancels in the softmax."""
    m = key_mask.float()
    k_pos = torch.clamp(torch.cumsum(m, dim=-1) - 1.0, min=0.0) * m
    slopes = torch.from_numpy(alibi_slopes(n_heads)).to(key_mask.device)
    return slopes[None, :, None, None] * k_pos[:, None, None, :]


def window_bias(q_positions: torch.Tensor, key_mask: torch.Tensor, window: int) -> torch.Tensor:
    """Additive sliding-window term of a cached call: -1e9 on keys whose
    position trails the query's by `window` or more. q_positions [b, t],
    key_mask [b, S] -> [b, 1, t, S] f32."""
    k_pos = torch.clamp(torch.cumsum(key_mask.to(torch.int64), dim=-1) - 1, min=0)
    delta = q_positions[:, :, None] - k_pos[:, None, :]
    return torch.where(delta >= window, -1e9, 0.0)[:, None].to(torch.float32)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.einsum's type promotion: both operands in their promoted type."""
    ct = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(ct), b.to(ct))


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
        bias = cfg.use_bias if cfg.attn_bias is None else cfg.attn_bias
        lin = lambda name, i, o: make_linear(cfg, name, i, o, bias, device, generator)
        self.q_proj = lin("q_proj", d, nh * hd)
        self.k_proj = lin("k_proj", d, nkv * hd)
        self.v_proj = lin("v_proj", d, nkv * hd)
        self.o_proj = lin("o_proj", nh * hd, d)
        if cfg.prefix_tokens > 0:
            # prefix tuning: keys and values every query sees, unrotated
            # like a cache's (the JAX `prefix_k` / `prefix_v`)
            shape = (cfg.prefix_tokens, nkv, hd)
            self.prefix_k = nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))
            self.prefix_v = nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))
            _normal_(self.prefix_k, 0.02, generator)
            _normal_(self.prefix_v, 0.02, generator)

    def forward(
        self,
        h: torch.Tensor,  # [b, t, d]
        attn_bias: torch.Tensor,  # [b, 1, t, S] additive, f32
        positions: torch.Tensor,  # [b, t]
        layer_cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: Optional[torch.Tensor] = None,  # [b] per-row write offsets
        attn_mask: Optional[torch.Tensor] = None,  # [b, t] write validity
        attn_kernel: Optional[str] = None,  # paged decode read: None (gather) | "kernel"
        adapters: bool = True,  # False: no LoRA delta, no prefixes (the reference forward)
    ):
        cfg = self.cfg
        b, t, d = h.shape
        nh, nkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        q = self.q_proj(h, adapters).reshape(b, t, nh, hd)
        k = self.k_proj(h, adapters).reshape(b, t, nkv, hd)
        v = self.v_proj(h, adapters).reshape(b, t, nkv, hd)
        if cfg.pos_embed == "rope":
            q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_dim)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_dim)

        if layer_cache is None:
            if fused_attention_ok(cfg, t) and attn_mask is not None:
                # Fused training/scoring path: causal and key-padding
                # structure come from `attn_mask` inside the kernels
                # (attn_bias encodes exactly that structure and is
                # ignored); K/V stay at n_kv_heads.
                from trlx_tpu_torch.ops.attention import flash_attention

                out = flash_attention(q, k, v, mask=attn_mask, causal=True).to(cfg.dtype)
                return self.o_proj(out.reshape(b, t, nh * hd), adapters), None
            return self._dense(q, k, v, attn_bias, adapters), None
        if "table" not in layer_cache:
            # Fixed-slot dense cache (the sampler's): write this step's K/V
            # in place at the scalar column `cache_index` (every row at one
            # depth) or at per-row columns (a [b] tensor: the speculative
            # sampler's rows diverge), then attend over the whole
            # static-length cache under the caller's bias. Per-row starts
            # clamp to [0, S - t] as JAX's dynamic_update_slice does.
            ck, cv = layer_cache["k"], layer_cache["v"]
            if torch.is_tensor(cache_index) and cache_index.dim() == 1:
                start = cache_index.clamp(0, ck.shape[1] - t)
                cols = start[:, None] + torch.arange(t, device=h.device)[None, :]
                rows = torch.arange(b, device=h.device)[:, None]
                ck[rows, cols] = k.to(ck.dtype)
                cv[rows, cols] = v.to(cv.dtype)
            else:
                idx = int(cache_index)
                ck[:, idx:idx + t] = k.to(ck.dtype)
                cv[:, idx:idx + t] = v.to(cv.dtype)
            return self._dense(q, ck, cv, attn_bias, adapters), layer_cache
        # Paged KV pool: a global block arena k/v [n_blocks + 1, blk, nkv,
        # hd] shared by every slot plus a per-row block table [b, n_tbl].
        # This step's K/V is written in place at per-row columns
        # [cache_index, cache_index + t).
        table = layer_cache["table"]
        arena_k, arena_v = layer_cache["k"], layer_cache["v"]
        n_blocks, blk_sz = arena_k.shape[0] - 1, arena_k.shape[1]  # last block: dropped writes
        n_tbl = table.shape[1]
        cols = cache_index[:, None] + torch.arange(t, device=h.device)[None, :]  # [b, t]
        blk = torch.clamp(cols // blk_sz, 0, n_tbl - 1)
        phys = torch.gather(table, 1, blk)
        off = cols % blk_sz
        # the writes JAX drops as out of bounds: right pad and inactive
        # rows (attn_mask 0) and padding rows whose tables are all n_blocks
        write = (phys >= 0) & (phys < n_blocks)
        if attn_mask is not None:
            write = write & attn_mask.bool()
        phys = torch.where(write, phys, torch.full_like(phys, n_blocks)).long()
        off = off.long()
        quantized = arena_k.dtype == torch.int8
        if quantized:
            kq, ks = quant.quantize_kv(k)
            vq, vs = quant.quantize_kv(v)
            arena_k[phys, off] = kq
            arena_v[phys, off] = vq
            layer_cache["k_scale"][phys, off] = ks
            layer_cache["v_scale"][phys, off] = vs
        else:
            arena_k[phys, off] = k.to(arena_k.dtype)
            arena_v[phys, off] = v.to(arena_v.dtype)

        if attn_kernel is not None:
            # fused read side (ops/paged_attention.py): the CUDA kernel on
            # a cuda device, its plain version on the CPU
            if t != 1:
                raise ValueError(f"paged decode kernel takes single-position queries; got t={t}")
            if cfg.alibi or cfg.sliding_window is not None or cfg.prefix_tokens > 0:
                raise ValueError("paged decode kernel cannot express alibi/window/prefix bias terms "
                                 "(the engine should have fallen back)")
            from trlx_tpu_torch.ops.paged_attention import paged_attention_decode

            # decode_bias writes exactly 0.0 on attendable columns
            key_mask = attn_bias[:, 0, 0, :] == 0.0
            out = paged_attention_decode(
                q[:, 0].contiguous(), arena_k, arena_v, table, key_mask,
                k_scale=layer_cache.get("k_scale"), v_scale=layer_cache.get("v_scale"),
                out_dtype=cfg.dtype,
            )
            return self.o_proj(out.reshape(b, 1, nh * hd), adapters), layer_cache

        idx = table.long().clamp(0, arena_k.shape[0] - 1)
        S = n_tbl * blk_sz
        if quantized:
            k = quant.dequantize_kv(
                arena_k[idx].reshape(b, S, nkv, hd), layer_cache["k_scale"][idx].reshape(b, S, nkv), cfg.dtype
            )
            v = quant.dequantize_kv(
                arena_v[idx].reshape(b, S, nkv, hd), layer_cache["v_scale"][idx].reshape(b, S, nkv), cfg.dtype
            )
        else:
            k = arena_k[idx].reshape(b, S, nkv, hd)
            v = arena_v[idx].reshape(b, S, nkv, hd)
        return self._dense(q, k, v, attn_bias, adapters), layer_cache

    def _dense(self, q, k, v, attn_bias, adapters: bool = True):
        """The einsum path: the prefixes (when on) before the keys and
        values, f32 scores, the additive bias, softmax in f32,
        probabilities cast to cfg.dtype, then o_proj."""
        cfg = self.cfg
        b, t, nh, hd = q.shape
        if cfg.prefix_tokens > 0 and adapters:
            # after the cache update, in the keys' dtype; every query sees them
            P = cfg.prefix_tokens
            k = torch.cat([self.prefix_k.to(k.dtype)[None].expand(b, -1, -1, -1), k], dim=1)
            v = torch.cat([self.prefix_v.to(v.dtype)[None].expand(b, -1, -1, -1), v], dim=1)
            attn_bias = torch.cat([attn_bias.new_zeros(attn_bias.shape[:3] + (P,)), attn_bias], dim=-1)
        if k.shape[2] != nh:  # GQA: q head h reads kv head h // group
            k = k.repeat_interleave(nh // k.shape[2], dim=2)
            v = v.repeat_interleave(nh // v.shape[2], dim=2)
        # [b, h, t, S] scores in f32 (preferred_element_type=f32)
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (1.0 / math.sqrt(hd))
        probs = torch.softmax(scores + attn_bias, dim=-1).to(cfg.dtype)
        out = _einsum("bhts,bshd->bthd", probs, v).reshape(b, t, nh * hd)
        return self.o_proj(out, adapters)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        lin = lambda name, i, o: make_linear(cfg, name, i, o, cfg.use_bias, device, generator)
        self.up_proj = lin("up_proj", cfg.d_model, cfg.d_ff)
        if cfg.glu:
            self.gate_proj = lin("gate_proj", cfg.d_model, cfg.d_ff)
        self.down_proj = lin("down_proj", cfg.d_ff, cfg.d_model)
        self.act = activation_fn(cfg)

    def forward(self, h, adapters: bool = True):
        if self.cfg.glu:
            return self.down_proj(self.act(self.gate_proj(h, adapters)) * self.up_proj(h, adapters), adapters)
        return self.down_proj(self.act(self.up_proj(h, adapters)), adapters)


# The MoE MLPs of one forward append their load-balancing terms here while
# a `collect_moe_aux` block is open in this thread; None: nothing collects
_MOE_AUX: contextvars.ContextVar = contextvars.ContextVar("moe_aux", default=None)


@contextmanager
def collect_moe_aux():
    """Collect the load-balancing terms of the MoE MLPs that run inside
    the block, in this thread only: yields the list they are appended to
    (the JAX package's sown `intermediates`, scoped to one call, so no
    scoring pass, decode step or server thread leaks its terms into a
    training loss)."""
    terms = []
    token = _MOE_AUX.set(terms)
    try:
        yield terms
    finally:
        _MOE_AUX.reset(token)


def _expert_init_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `variance_scaling(1.0, "fan_in", "truncated_normal")` with the
    expert axis as a batch axis: fan_in is one expert's input width."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the std of a unit normal truncated at 2
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class MoEMLP(nn.Module):
    """The mixture-of-experts MLP (the JAX `MoEMLP`): an f32 router, top-k
    token-choice gates renormalised over the chosen experts, and dense
    dispatch: every expert computes every token in cfg.dtype and the
    gates (zero off the chosen experts) mix the outputs. Parameters keep
    the JAX names and shapes: `router` [d -> E] with no bias, `up_proj`
    and `gate_proj` [E, d, f], `down_proj` [E, f, d], `up_bias` [E, f] and
    `down_bias` [E, d] under `use_bias`. While `collect_moe_aux` is open
    each call appends its Switch-style term E * sum_e(frac_routed_e *
    mean_prob_e), the means over every position (padding included, as in
    JAX); the one-hot of the chosen experts carries no gradient."""

    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        E, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
        # nn.Dense(dtype=f32): the input and the kernel are cast to f32
        self.router = Linear(d, E, False, torch.float32, cfg.param_dtype, device, generator)
        pd = cfg.param_dtype
        self.up_proj = nn.Parameter(_expert_init_(torch.empty(E, d, f, dtype=pd, device=device), d, generator))
        if cfg.glu:
            self.gate_proj = nn.Parameter(_expert_init_(torch.empty(E, d, f, dtype=pd, device=device), d, generator))
        self.down_proj = nn.Parameter(_expert_init_(torch.empty(E, f, d, dtype=pd, device=device), f, generator))
        if cfg.use_bias:
            self.up_bias = nn.Parameter(torch.zeros(E, f, dtype=pd, device=device))
            self.down_bias = nn.Parameter(torch.zeros(E, d, dtype=pd, device=device))
        self.act = activation_fn(cfg)

    def select(self, probs):
        """The chosen experts [..., k] of each position, the most probable
        first: a stable descending sort, so equal probabilities go to the
        lower expert first, as `lax.top_k` does."""
        return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :self.cfg.moe_top_k]

    def route(self, h):
        """(probs, gates, selected), each [..., E] f32: the router's
        softmax, the renormalised top-k weights scattered to their experts,
        and the one-hot of the chosen experts (`select`)."""
        E = self.cfg.moe_experts
        probs = torch.softmax(self.router(h), dim=-1)
        top_i = self.select(probs.detach())
        top_w = torch.gather(probs, -1, top_i)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
        onehot = F.one_hot(top_i, E).to(probs.dtype)  # [..., k, E]
        gates = (top_w[..., None] * onehot).sum(-2)
        return probs, gates, onehot.sum(-2)

    def forward(self, h, adapters: bool = True):
        cfg = self.cfg
        E, dt = cfg.moe_experts, cfg.dtype
        probs, gates, selected = self.route(h)
        terms = _MOE_AUX.get()
        if terms is not None:
            frac_routed = selected.reshape(-1, E).mean(0)
            mean_prob = probs.reshape(-1, E).mean(0)
            terms.append(E * torch.sum(frac_routed * mean_prob))
        shape = h.shape
        x = h.reshape(-1, shape[-1]).to(dt)  # [N, d]
        # one batched product per expert weight: [N, d] x [E, d, f] -> [E, N, f]
        hidden = torch.matmul(x, self.up_proj.to(dt))
        if cfg.use_bias:
            hidden = hidden + self.up_bias.to(dt)[:, None]
        if cfg.glu:
            hidden = self.act(torch.matmul(x, self.gate_proj.to(dt))) * hidden
        else:
            hidden = self.act(hidden)
        out = torch.matmul(hidden, self.down_proj.to(dt))  # [E, N, d]
        if cfg.use_bias:
            out = out + self.down_bias.to(dt)[:, None]
        return torch.einsum("ne,end->nd", gates.reshape(-1, E).to(dt), out).reshape(shape)


class Block(nn.Module):
    """Pre-norm block, sequential (h + attn, then + mlp) or, under
    `parallel_residual`, h + attn(ln_attn(h)) + mlp(ln_mlp(h)) (GPT-NeoX);
    with `shared_ln` the MLP reads ln_attn's output and the block has no
    ln_mlp (GPT-J), as the JAX tree has none."""

    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = make_norm(cfg, device)
        self.attn = Attention(cfg, device, generator)
        if not (cfg.parallel_residual and cfg.shared_ln):
            self.ln_mlp = make_norm(cfg, device)
        self.mlp = (MoEMLP if cfg.moe_experts > 0 else MLP)(cfg, device, generator)

    def forward(self, h, attn_bias, positions, layer_cache=None, cache_index=None,
                attn_mask=None, attn_kernel=None, adapters: bool = True):
        h_ln = self.ln_attn(h)
        attn_out, new_cache = self.attn(h_ln, attn_bias, positions, layer_cache, cache_index, attn_mask, attn_kernel,
                                        adapters)
        if self.cfg.parallel_residual:
            mlp_in = h_ln if self.cfg.shared_ln else self.ln_mlp(h)
            return h + attn_out + self.mlp(mlp_in, adapters), new_cache
        h = h + attn_out
        h = h + self.mlp(self.ln_mlp(h), adapters)
        return h, new_cache


def position_ids(attn_mask: torch.Tensor) -> torch.Tensor:
    """Position ids robust to left padding: cumsum of the mask - 1, clipped."""
    return torch.clamp(torch.cumsum(attn_mask.to(torch.int64), dim=-1) - 1, min=0)


def decode_bias(cache_mask: torch.Tensor, t: int) -> torch.Tensor:
    """Bias during cached decode: 0.0 on every valid cache column, -1e9
    elsewhere. [b, S] -> [b, 1, 1, S] f32."""
    allowed = cache_mask[:, None, None, :].bool()
    return torch.where(allowed, 0.0, -1e9).to(torch.float32)


def causal_bias(attn_mask: torch.Tensor, sliding_window: Optional[int] = None) -> torch.Tensor:
    """Additive bias of a no-cache forward: causal plus key padding, and
    the sliding-window band when set (query i sees keys in (i - window,
    i]). attn_mask [b, t] (1 = real token) -> [b, 1, t, t] f32, 0.0 where
    allowed and -1e9 elsewhere."""
    t = attn_mask.shape[-1]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=attn_mask.device))
    if sliding_window is not None:
        ids = torch.arange(t, device=attn_mask.device)
        causal = causal & ((ids[:, None] - ids[None, :]) < sliding_window)
    allowed = causal[None, None] & attn_mask[:, None, None, :].bool()
    return torch.where(allowed, 0.0, -1e9).to(torch.float32)


def train_bias(cfg: TransformerConfig, attn_mask: torch.Tensor) -> Optional[torch.Tensor]:
    """Additive bias for a no-cache forward, or None when the flash kernels
    build the structure themselves (`fused_attention_ok` at the mask's
    length, as Attention decides): causal, the window's band and ALiBi's
    term."""
    if fused_attention_ok(cfg, attn_mask.shape[-1]):
        return None
    bias = causal_bias(attn_mask, cfg.sliding_window)
    if cfg.alibi:
        bias = bias + alibi_bias(attn_mask, cfg.n_heads)
    return bias


def cached_bias(cfg: TransformerConfig, cache_mask: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The bias of a cached call over the cache columns `cache_mask` [b,
    S] for queries at `positions` [b, t]: `decode_bias`, then the ALiBi
    and window terms, added in the JAX package's order."""
    bias = decode_bias(cache_mask, positions.shape[1])
    if cfg.alibi:
        bias = bias + alibi_bias(cache_mask, cfg.n_heads)
    if cfg.sliding_window is not None:
        bias = bias + window_bias(positions, cache_mask, cfg.sliding_window)
    return bias


def embed_inputs(mod: nn.Module, cfg: TransformerConfig, tokens, positions):
    """Token embedding, the learned positions read at positions +
    pos_offset, and the embedding norm: `TransformerLM.embed` for any
    module holding those submodules (the LM, the split-0 reference)."""
    h = mod.embed_tokens(tokens)
    if cfg.pos_embed == "learned":
        h = h + mod.embed_pos(positions + cfg.pos_offset)
    if cfg.embed_ln:
        h = mod.ln_embed(h)
    return h


class TransformerLM(nn.Module):
    """Decoder-only LM; blocks are registered as `block_{i}` like the JAX
    parameter tree."""

    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, cfg.param_dtype, device, generator)
        if cfg.pos_embed == "learned":
            self.embed_pos = Embed(cfg.max_seq_len + cfg.pos_offset, cfg.d_model, cfg.dtype, cfg.param_dtype,
                                   device, generator)
        if cfg.embed_ln:
            self.ln_embed = make_norm(cfg, device)
        if cfg.prompt_tokens > 0:
            # prompt tuning's trainable embeddings (the JAX `soft_prompt`)
            self.soft_prompt = nn.Parameter(torch.empty(cfg.prompt_tokens, cfg.d_model, dtype=cfg.param_dtype,
                                                        device=device))
            _normal_(self.soft_prompt, 0.02, generator)
        self.blocks = []
        for i in range(cfg.n_layers):
            blk = Block(cfg, device, generator)
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)
        self.ln_f = make_norm(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab_size, cfg.lm_head_bias, cfg.dtype, cfg.param_dtype,
                                  device, generator)

    def embed(self, tokens, positions):
        return embed_inputs(self, self.cfg, tokens, positions)

    def _embed_soft_prompt(self, b, positions_virt):
        """The soft prompt's rows as embeddings [b, P, d], with the
        positions and the embedding norm real tokens get."""
        cfg = self.cfg
        h = self.soft_prompt.to(cfg.dtype)[None].expand(b, -1, -1)
        if cfg.pos_embed == "learned":
            h = h + self.embed_pos(positions_virt + cfg.pos_offset)
        if cfg.embed_ln:
            h = self.ln_embed(h)
        return h

    def _embed_prompted(self, tokens, attn_mask, positions):
        """Prompt tuning's input: the soft prompt's P rows before the
        tokens. Returns (h, attn_mask, positions), all P columns wider:
        without given positions they come from the widened mask, else the
        prompt takes 0..P-1 and the tokens' shift by P (as JAX's)."""
        b, P = tokens.shape[0], self.cfg.prompt_tokens
        attn_mask = torch.cat([attn_mask.new_ones((b, P)), attn_mask], dim=1)
        if positions is None:
            positions = position_ids(attn_mask)
        else:
            virt = torch.arange(P, dtype=positions.dtype, device=positions.device)[None].expand(b, P)
            positions = torch.cat([virt, positions + P], dim=1)
        h = torch.cat([self._embed_soft_prompt(b, positions[:, :P]), self.embed(tokens, positions[:, P:])], dim=1)
        return h, attn_mask, positions

    def unembed(self, h):
        """Final norm + output projection. Returns (logits, h_final)."""
        h_final = self.ln_f(h)
        if self.cfg.tie_embeddings:
            return self.embed_tokens.attend(h_final), h_final
        return self.lm_head(h_final), h_final

    def run_blocks(self, h, attn_bias, positions, cache, cache_index, attn_mask=None, attn_kernel=None,
                   start: int = 0, stop: Optional[int] = None):
        """Blocks [start, stop) over their layer caches (indexed by absolute
        layer). Returns (h, the caches of those layers)."""
        new_layers = []
        for i in range(start, self.cfg.n_layers if stop is None else stop):
            h, new_cache = self.blocks[i](h, attn_bias, positions, cache[i], cache_index, attn_mask, attn_kernel)
            new_layers.append(new_cache)
        return h, new_layers

    def forward(self, tokens, attn_mask, positions=None, split: int = 0, adapters: bool = True):
        """Training/scoring forward (no cache). tokens, attn_mask [b, t].
        Returns (logits, h_split, h_final): h_split is the activation
        entering block `split` (the embedding output for split 0).
        `adapters=False` runs the base model alone (no LoRA delta, soft
        prompt or prefixes): the reference forward under adapters."""
        return self.forward_captures(tokens, attn_mask, positions, split, split, adapters)[:3]

    def forward_captures(self, tokens, attn_mask, positions=None, split: int = 0, value_split: int = 0,
                         adapters: bool = True):
        """`forward` that also keeps the activation entering block
        `value_split`, the deeper value branch's input. Returns (logits,
        h_split, h_final, h_value); a split at or past the last block
        captures the last block's output. Under prompt tuning (with the
        adapters on) the soft prompt is prepended and sliced off before
        the head, so the logits keep the caller's length; the captures
        carry the wider rows (their consumers take split 0 then)."""
        P = self.cfg.prompt_tokens if adapters else 0
        if P > 0:
            h, attn_mask, positions = self._embed_prompted(tokens, attn_mask, positions)
        else:
            if positions is None:
                positions = position_ids(attn_mask)
            h = self.embed(tokens, positions)
        n = self.cfg.n_layers
        split, value_split = min(split, n), min(value_split, n)
        caps = {}
        bounds = sorted({0, split, value_split, n})
        for s, e in zip(bounds, bounds[1:]):
            caps[s] = h
            h = self._run_from(h, attn_mask, positions, s, e, adapters)
        caps[n] = h
        logits, h_final = self.unembed(h[:, P:] if P > 0 else h)
        return logits, caps[split], h_final, caps[value_split]

    def forward_window(self, tokens, attn_mask, positions=None, start: int = 0, length: int = 1):
        """The trunk over the full sequence, the final norm and unembedding
        over positions [start, start + length) only: the slice a PPO step
        reads (the [b, t, V] head was the largest product of the step).
        Returns (logits_win, h_final_win)."""
        if self.cfg.prompt_tokens > 0:
            raise NotImplementedError("forward_window under prompt tuning is unsupported; use the full forward "
                                      "(the soft prompt shifts every position)")
        if positions is None:
            positions = position_ids(attn_mask)
        return self.forward_from_window(self.embed(tokens, positions), attn_mask, positions, 0, start, length)

    def forward_trunk(self, tokens, attn_mask, positions=None, split: int = 0):
        """Embeddings and blocks [0, split) only: the activation entering
        block `split` (the h_split `forward` returns), no head. One such
        pass per rollout chunk fills the PPO trunk cache."""
        if self.cfg.prompt_tokens > 0:
            raise NotImplementedError("forward_trunk under prompt tuning is unsupported (the soft prompt widens "
                                      "the captured rows; resolve_split gates it off)")
        if positions is None:
            positions = position_ids(attn_mask)
        return self._run_from(self.embed(tokens, positions), attn_mask, positions, 0, split)

    def forward_from_captures(self, h, attn_mask, positions=None, start_layer: int = 0,
                              value_split: Optional[int] = None):
        """Resume blocks [start_layer, n_layers) from a cached activation
        `h` entering `start_layer`, full-width head. Returns (logits,
        h_final, h_value): h_value is the activation entering block
        `value_split` (the deeper value branch's input; start_layer <=
        value_split), or `h` itself when it is None."""
        if positions is None:
            positions = position_ids(attn_mask)
        vs = start_layer if value_split is None else value_split
        if vs < start_layer:
            raise ValueError(f"value_split {vs} lies below start_layer {start_layer}: its input is not derivable")
        h_value = h
        if vs > start_layer:
            h = h_value = self._run_from(h, attn_mask, positions, start_layer, vs)
        logits, h_final = self.unembed(self._run_from(h, attn_mask, positions, vs))
        return logits, h_final, h_value

    def forward_from_window(self, h, attn_mask, positions=None, start_layer: int = 0, start: int = 0,
                            length: int = 1):
        """`forward_from_captures` with `forward_window`'s head: blocks
        [start_layer, n_layers) over the full width, the final norm and
        unembedding over positions [start, start + length) only. Returns
        (logits_win, h_final_win)."""
        if positions is None:
            positions = position_ids(attn_mask)
        h = self._run_from(h, attn_mask, positions, start_layer)
        return self.unembed(h[:, start:start + length])

    def _run_from(self, h, attn_mask, positions, start_layer: int, stop_layer: Optional[int] = None,
                  adapters: bool = True):
        """Blocks [start_layer, stop_layer) of a no-cache forward."""
        bias = train_bias(self.cfg, attn_mask)
        for blk in self.blocks[start_layer:stop_layer]:
            h, _ = blk(h, bias, positions, attn_mask=attn_mask, adapters=adapters)
        return h

    def _no_virtual_tokens(self, what: str) -> None:
        if self.cfg.prompt_tokens > 0 or self.cfg.prefix_tokens > 0:
            raise NotImplementedError(f"{what} under prompt/prefix tuning is unsupported")

    def decode_step(self, tokens, cache: Dict[str, Any], token_mask, is_prefill: bool = False,
                    capture_split: Optional[int] = None):
        """One cached call over the fixed-slot dense cache (`init_kv_cache`):
        a prefill of the prompt block at the cache's write offset, or one
        decode step. The cache carries `index` (the write offset, a python
        int), `mask` [b, S], `pos` [b] (each row's next position id) and
        `layers`; its K/V tensors are written in place. Returns (logits,
        h_final, new_cache); with `capture_split` (the rollout fast path)
        also the activation entering that block, (logits, h_final,
        new_cache, h_cap). Under prompt tuning the prefill writes the soft
        prompt into the cache's first columns (`init_kv_cache` reserves
        them) and the logits keep the caller's length."""
        t = tokens.shape[1]
        index = int(cache["index"])
        P = self.cfg.prompt_tokens if is_prefill else 0
        if capture_split is not None and self.cfg.prompt_tokens > 0:
            raise NotImplementedError("split-activation capture under prompt tuning is unsupported (the soft "
                                      "prompt widens the captured rows)")
        if P > 0:
            h, token_mask, positions = self._embed_prompted(tokens, token_mask, None)
        t_ext = t + P
        if is_prefill:
            positions = position_ids(token_mask)
            next_pos = token_mask.sum(-1).to(torch.int64)
        else:
            positions = cache["pos"][:, None]
            next_pos = cache["pos"] + token_mask[:, 0].to(torch.int64)
        new_mask = cache["mask"].clone()
        new_mask[:, index:index + t_ext] = token_mask.to(new_mask.dtype)
        bias = cached_bias(self.cfg, new_mask, positions)
        if is_prefill:
            # causal structure within the prefill block
            S = new_mask.shape[-1]
            q_ids = torch.arange(t_ext, device=tokens.device)[:, None]
            k_ids = torch.arange(S, device=tokens.device)[None, :]
            within = (k_ids < index + t_ext) & (k_ids >= index) & (k_ids - index > q_ids)
            bias = bias + torch.where(within[None, None], -1e9, 0.0).to(torch.float32)
        if P == 0:
            h = self.embed(tokens, positions)
        h, new_layers = self.run_blocks(h, bias, positions, cache["layers"], index, stop=capture_split)
        if capture_split is not None:
            h_cap = h
            h, high = self.run_blocks(h, bias, positions, cache["layers"], index, start=capture_split)
            new_layers = new_layers + high
        logits, h_final = self.unembed(h[:, P:] if P > 0 else h)
        new_cache = {"index": index + t_ext, "mask": new_mask, "pos": next_pos, "layers": new_layers}
        if capture_split is not None:
            return logits, h_final, new_cache, h_cap
        return logits, h_final, new_cache

    def decode_step_rows(
        self,
        tokens: torch.Tensor,  # [b, 1]
        cache: Dict[str, Any],
        token_mask: torch.Tensor,  # [b, 1] validity (0 = free/inactive slot)
        attn_kernel: Optional[str] = None,
    ):
        """One cached decode step where every row carries its own write
        offset (`cache["row_index"]`, [b]) — the continuous-batching slot
        pool. Inactive rows write a 0 into the mask at their current
        column (a no-op) and do not advance; their arena writes go to the
        spare block. Returns (logits, new_cache)."""
        self._no_virtual_tokens("slot-pool decode")
        row_index = cache["row_index"]
        positions = cache["pos"][:, None]
        step_valid = token_mask[:, 0].to(row_index.dtype)
        mask = cache["mask"]
        S = mask.shape[-1]
        # a finished row may sit at column S, where JAX's scatter drops
        col = row_index.clamp(max=S - 1)[:, None]
        cur = torch.gather(mask, 1, col)
        val = torch.where(row_index[:, None] < S, token_mask[:, :1].to(mask.dtype), cur)
        new_mask = mask.scatter(1, col, val)
        bias = cached_bias(self.cfg, new_mask, positions)
        h = self.embed(tokens, positions)
        h, new_layers = self.run_blocks(
            h, bias, positions, cache["layers"], row_index, attn_mask=token_mask,
            attn_kernel=attn_kernel,
        )
        logits, _ = self.unembed(h)
        new_cache = {
            "row_index": row_index + step_valid,
            "mask": new_mask,
            "pos": cache["pos"] + step_valid,
            "layers": new_layers,
        }
        return logits, new_cache

    def spec_draft_step(
        self,
        tokens: torch.Tensor,  # [b, 1]
        cache: Dict[str, Any],
        token_mask: torch.Tensor,  # [b, 1] validity (0 = finished row)
        split: int,
        attn_kernel: Optional[str] = None,  # paged read path: None (gather) | "kernel"
    ):
        """One per-row cached step of the trunk only (blocks [0, split)) for
        self-speculative drafting, over the fixed-slot dense cache or the
        paged arena, with per-row offsets (`cache["row_index"]`, [b]). Writes
        the trunk's K/V at each row's own column and the row's mask bit,
        leaves the suffix layers' caches to the verify pass. The step is
        decode-shaped (t = 1), so over the arena it reads through the paged
        decode kernel when `attn_kernel` asks for it. A drafted position becomes a
        visible key only once its mask bit is set, so a rejected draft rolls
        back by clearing bits, and stale K/V past the frontier contributes
        exactly 0 (exp(-1e9) is 0.0 in f32). Returns (h_split [b, 1, d],
        ln_f(h_split), new_cache)."""
        self._no_virtual_tokens("speculative decode")
        row_index = cache["row_index"]
        positions = cache["pos"][:, None]
        step_valid = token_mask[:, 0].to(row_index.dtype)
        mask = cache["mask"]
        S = mask.shape[-1]
        # a row at column S is past the cache, where JAX's scatter drops
        col = row_index.clamp(max=S - 1)[:, None]
        cur = torch.gather(mask, 1, col)
        val = torch.where(row_index[:, None] < S, token_mask[:, :1].to(mask.dtype), cur)
        new_mask = mask.scatter(1, col, val)
        bias = cached_bias(self.cfg, new_mask, positions)
        h = self.embed(tokens, positions)
        h, _ = self.run_blocks(h, bias, positions, cache["layers"], row_index, attn_mask=token_mask,
                               attn_kernel=attn_kernel, stop=split)
        new_cache = {
            "row_index": row_index + step_valid,
            "mask": new_mask,
            "pos": cache["pos"] + step_valid,
            "layers": cache["layers"],
        }
        return h, self.ln_f(h), new_cache

    def spec_verify_rows(
        self,
        h: torch.Tensor,  # [b, t, d] the trunk's output at the t drafted positions
        cache: Dict[str, Any],
        row_start: torch.Tensor,  # [b] cache column of h's first position
        positions: torch.Tensor,  # [b, t]
        split: int,
        token_mask: Optional[torch.Tensor] = None,  # [b, t] write validity
    ):
        """The batched suffix verify of self-speculative decode: blocks
        [split, n_layers) resumed from the trunk's own rows, writing the
        suffix K/V of all t positions in one pass. The draft steps already
        set the mask bits of columns [row_start, row_start + t); within
        that span query j may not see keys written for later queries (the
        prefill's within-block causal correction with per-row offsets;
        doubly forbidden columns carry -2e9, still exactly 0 after the
        softmax). Returns (logits, h_final, layers)."""
        b, t, _ = h.shape
        mask = cache["mask"]
        S = mask.shape[-1]
        bias = cached_bias(self.cfg, mask, positions)
        q_ids = torch.arange(t, device=h.device)[None, :, None]
        k_ids = torch.arange(S, device=h.device)[None, None, :]
        start = row_start[:, None, None]
        within = (k_ids >= start) & (k_ids - start > q_ids)  # [b, t, S]
        bias = bias + torch.where(within[:, None], -1e9, 0.0).to(torch.float32)
        h, _ = self.run_blocks(h, bias, positions, cache["layers"], row_start, attn_mask=token_mask,
                               start=split)
        logits, h_final = self.unembed(h)
        return logits, h_final, cache["layers"]

    def prefill_rows(
        self,
        tokens: torch.Tensor,  # [b, t] RIGHT-padded prompt (suffix) tokens
        cache: Dict[str, Any],
        token_mask: torch.Tensor,  # [b, t] validity (0 = right pad)
    ):
        """Multi-token cached prefill where every row carries its own write
        offset (`cache["row_index"]`): row r's valid tokens occupy columns
        [row_index_r, row_index_r + len_r); queries see every valid cache
        column plus the causal prefix of their own span. Right-pad
        positions write nothing the model can see. Returns (logits,
        new_cache)."""
        self._no_virtual_tokens("slot-pool prefill")
        b, t = tokens.shape
        row_index = cache["row_index"]
        lens = token_mask.sum(-1).to(row_index.dtype)
        positions = cache["pos"][:, None] + position_ids(token_mask)
        mask = cache["mask"]
        S = mask.shape[-1]
        cols = row_index[:, None] + torch.arange(t, device=tokens.device)[None, :]
        # pad columns land on already-zero cells (or clip to S-1, also zero
        # until decode begins), so their 0 writes are no-ops
        new_mask = mask.scatter(1, cols.clamp(0, S - 1), token_mask.to(mask.dtype))
        bias = cached_bias(self.cfg, new_mask, positions)
        q_ids = torch.arange(t, device=tokens.device)[None, :, None]
        k_ids = torch.arange(S, device=tokens.device)[None, None, :]
        start = row_index[:, None, None]
        within = (k_ids >= start) & (k_ids - start > q_ids)  # [b, t, S]
        bias = bias + torch.where(within[:, None], -1e9, 0.0).to(torch.float32)
        h = self.embed(tokens, positions)
        h, new_layers = self.run_blocks(
            h, bias, positions, cache["layers"], row_index, attn_mask=token_mask,
        )
        logits, _ = self.unembed(h)
        new_cache = {
            "row_index": row_index + lens,
            "mask": new_mask,
            "pos": cache["pos"] + lens,
            "layers": new_layers,
        }
        return logits, new_cache


def init_kv_cache(cfg: TransformerConfig, batch_size: int, max_len: int, dtype=None, device=None):
    """An empty fixed-slot KV cache of `max_len` columns per row (see
    `TransformerLM.decode_step`), and `cfg.prompt_tokens` more for the
    soft prompt that the prefill writes first."""
    dtype = dtype or cfg.dtype
    max_len = max_len + cfg.prompt_tokens
    shape = (batch_size, max_len, cfg.kv_heads, cfg.head_dim)
    layers = [
        {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.n_layers)
    ]
    return {
        "index": 0,
        "mask": torch.zeros((batch_size, max_len), dtype=torch.int32, device=device),
        "pos": torch.zeros((batch_size,), dtype=torch.int64, device=device),
        "layers": layers,
    }


def init_paged_kv_arena(cfg: TransformerConfig, num_blocks: int, block_size: int,
                        dtype=None, device=None):
    """Allocate the per-layer paged KV arenas: `num_blocks` blocks of
    `block_size` token columns each, plus one spare block at index
    `num_blocks` that receives the writes JAX drops as out of bounds (no
    table names it). Block 0 is reserved by the engine as the zero block
    backing padding table entries. int8 arenas carry f32 scale planes
    (per token per kv head, ops/quant.quantize_kv)."""
    if cfg.prompt_tokens > 0 or cfg.prefix_tokens > 0:
        raise NotImplementedError("paged KV cache under prompt/prefix tuning is unsupported")
    dtype = dtype or cfg.dtype
    shape = (num_blocks + 1, block_size, cfg.kv_heads, cfg.head_dim)
    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
        if dtype == torch.int8:
            layer["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
            layer["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        layers.append(layer)
    return layers


# ---------------------------------------------------------------------------
# Model family presets (the JAX package's table)
# ---------------------------------------------------------------------------

PRESETS: Dict[str, Dict[str, Any]] = {
    "gpt2-tiny": dict(d_model=64, n_layers=2, n_heads=4, d_ff=256, max_seq_len=256),
    "gpt2-small": dict(d_model=768, n_layers=12, n_heads=12, d_ff=3072, max_seq_len=1024),
    "gpt2-medium": dict(d_model=1024, n_layers=24, n_heads=16, d_ff=4096, max_seq_len=1024),
    "gpt2-large": dict(d_model=1280, n_layers=36, n_heads=20, d_ff=5120, max_seq_len=1024),
    "gpt2-xl": dict(d_model=1600, n_layers=48, n_heads=25, d_ff=6400, max_seq_len=1024),
    "llama-tiny": dict(
        d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=256,
        pos_embed="rope", norm="rmsnorm", activation="silu", glu=True,
        tie_embeddings=False, use_bias=False,
    ),
    "llama-7b": dict(
        d_model=4096, n_layers=32, n_heads=32, d_ff=11008, max_seq_len=4096,
        pos_embed="rope", norm="rmsnorm", activation="silu", glu=True,
        tie_embeddings=False, use_bias=False,
    ),
    "neox-tiny": dict(
        d_model=64, n_layers=2, n_heads=4, d_ff=256, max_seq_len=256,
        pos_embed="rope", rotary_pct=0.25, activation="gelu_exact",
        parallel_residual=True, tie_embeddings=False,
    ),
    "pythia-160m": dict(
        d_model=768, n_layers=12, n_heads=12, d_ff=3072, max_seq_len=2048,
        pos_embed="rope", rotary_pct=0.25, activation="gelu_exact",
        parallel_residual=True, tie_embeddings=False,
    ),
    "pythia-1.4b": dict(
        d_model=2048, n_layers=24, n_heads=16, d_ff=8192, max_seq_len=2048,
        pos_embed="rope", rotary_pct=0.25, activation="gelu_exact",
        parallel_residual=True, tie_embeddings=False,
    ),
    "pythia-6.9b": dict(
        d_model=4096, n_layers=32, n_heads=32, d_ff=16384, max_seq_len=2048,
        pos_embed="rope", rotary_pct=0.25, activation="gelu_exact",
        parallel_residual=True, tie_embeddings=False,
    ),
    "gptj-tiny": dict(
        d_model=64, n_layers=2, n_heads=4, d_ff=256, max_seq_len=256,
        pos_embed="rope", rotary_pct=0.5, parallel_residual=True, shared_ln=True,
        tie_embeddings=False, attn_bias=False, lm_head_bias=True,
    ),
    "gptj-6b": dict(
        d_model=4096, n_layers=28, n_heads=16, d_ff=16384, max_seq_len=2048,
        pos_embed="rope", rotary_pct=0.25, parallel_residual=True, shared_ln=True,
        tie_embeddings=False, attn_bias=False, lm_head_bias=True,
    ),
    "opt-tiny": dict(
        d_model=64, n_layers=2, n_heads=4, d_ff=256, max_seq_len=256,
        activation="relu", pos_offset=2,
    ),
    "opt-125m": dict(
        d_model=768, n_layers=12, n_heads=12, d_ff=3072, max_seq_len=2048,
        activation="relu", pos_offset=2,
    ),
    "bloom-tiny": dict(
        d_model=64, n_layers=2, n_heads=4, d_ff=256, max_seq_len=256,
        pos_embed="none", alibi=True, embed_ln=True,
    ),
    "bloom-560m": dict(
        d_model=1024, n_layers=24, n_heads=16, d_ff=4096, max_seq_len=2048,
        pos_embed="none", alibi=True, embed_ln=True,
    ),
    "bigcode-tiny": dict(
        d_model=64, n_layers=2, n_heads=4, n_kv_heads=1, d_ff=256, max_seq_len=256,
    ),
    "moe-tiny": dict(
        d_model=64, n_layers=2, n_heads=4, d_ff=256, max_seq_len=256,
        moe_experts=4, moe_top_k=2,
    ),
}


def config_from_preset(name: str, vocab_size: int, **overrides) -> TransformerConfig:
    if name not in PRESETS:
        raise ValueError(f"Unknown model preset '{name}'. Available: {sorted(PRESETS)}")
    kwargs = dict(PRESETS[name])
    kwargs.update(overrides)
    return TransformerConfig(vocab_size=vocab_size, **kwargs)
