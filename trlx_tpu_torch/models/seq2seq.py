"""Encoder-decoder (T5-style) LM (PyTorch).

Port of the JAX package's `models/seq2seq.py`: `Seq2SeqConfig` (T5's
`d_kv` per-head width, HF-T5 numerics under `attention_scale=False` and
`logit_scale`), the bucketed relative position bias (`RelPosBias`, one
table per stack shared by its layers), `Seq2SeqLM` with `encode`,
`unembed`, the decoder forward split at a hydra point (`forward`,
`forward_from`), and the cached decode whose cross-attention K/V are
projected once at prefill (`prepare_cache`, `decode_step`); the value-head
and ILQL-head wrappers; the frozen reference over the decoder's top
(`Seq2SeqHydraReference`, the JAX `seq2seq_ref_param_subtree` with
`forward_ref_suffix` / `forward_ref_full`); `seq2seq_trainable_mask` and
`forward_seq2seq_policy_and_ref`; `SEQ2SEQ_PRESETS`.

Attention is plain torch, as the JAX package computes it outside Pallas:
f32 scores (`attention_scale` multiplies them by 1/sqrt(d_kv)), the
additive padding, causal and relative biases, softmax in f32, the
probabilities cast to `cfg.dtype` before p·V. No kernel of the port runs
here; the trainers' label logprob over the decoder's logits does.

Bucket boundaries: `relative_position_bucket` truncates an f32 log ratio,
so a one-ulp difference moves a position into the next bucket. The
buckets are computed on the CPU with the JAX package's f32 expression and
read on the device through a lookup table over the relative positions
(`_bucket_table`), so every device gets the CPU's buckets.

Parameters carry the JAX tree's names (`lm.enc_block_0.attn.q_proj.weight`,
`lm.dec_rel_bias.embedding.weight`, ...), so `convert.params_from_jax`
maps them mechanically.
"""

import copy
import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from trlx_tpu_torch.models.heads import ILQLHeads, MLPHead
from trlx_tpu_torch.models.transformer import (
    Embed,
    Linear,
    _einsum,
    activation_fn,
    causal_bias,
    make_norm,
    position_ids,
)


@dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int
    d_model: int
    n_encoder_layers: int
    n_decoder_layers: int
    n_heads: int
    d_ff: int
    # T5's per-head width (HF `d_kv`): flan-t5-small has d_model 512, 6
    # heads, d_kv 64. None: d_model // n_heads
    d_kv: Optional[int] = None
    max_seq_len: int = 512
    norm: str = "rmsnorm"
    activation: str = "relu"
    glu: bool = False
    tie_embeddings: bool = True
    use_bias: bool = False
    relative_attention: bool = True
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    decoder_start_token_id: int = 0
    # the source tokenizer's special ids, recorded at HF import so an
    # export keeps them; None: T5's (pad 0, eos 1)
    pad_token_id: Optional[int] = None
    eos_token_id: Optional[int] = None
    layer_norm_epsilon: float = 1e-6
    # HF-T5 numerics: no 1/sqrt(d_kv) on the scores, tied logits scaled
    # by d_model**-0.5; the presets keep the standard scaling
    attention_scale: bool = True
    logit_scale: Optional[float] = None
    hf_family: Optional[str] = None
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    # the causal knobs the trainers read, none of which an encoder-decoder
    # has (class attributes, not fields)
    is_seq2seq = True
    moe_experts = 0
    lora_rank = 0
    prompt_tokens = 0
    prefix_tokens = 0
    attn_impl = "xla"

    @property
    def head_dim(self) -> int:
        return self.d_kv if self.d_kv is not None else self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_heads

    @property
    def n_layers(self) -> int:
        """The hydra split's and the freezing's axis: the decoder's depth
        (the reference branch is decoder-only)."""
        return self.n_decoder_layers


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's log-spaced relative position buckets (int64), by the JAX
    package's f32 expression: log(n / max_exact) / log(max_distance /
    max_exact), the divisor rounded to f32, scaled and truncated toward
    zero."""
    n = -relative_position.to(torch.int64)
    ret = torch.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int64) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    ratio = torch.log(n.clamp(min=1).to(torch.float32) / torch.tensor(float(max_exact)))
    ratio = ratio / torch.tensor(np.float32(np.log(max_distance / max_exact)))
    val_large = max_exact + (ratio * torch.tensor(float(num_buckets - max_exact))).to(torch.int64)
    val_large = val_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


@functools.lru_cache(maxsize=64)
def _bucket_table(length: int, bidirectional: bool, num_buckets: int, max_distance: int,
                  device: str) -> torch.Tensor:
    """The bucket of every relative position in [-(length - 1), length - 1],
    computed on the CPU, on `device`: entry r + length - 1 is r's."""
    rel = torch.arange(-(length - 1), length, dtype=torch.int64)
    return relative_position_bucket(rel, bidirectional, num_buckets, max_distance).to(device)


class RelPosBias(nn.Module):
    """Bucketed relative attention bias, one [num_buckets, n_heads] table a
    stack, shared by all its layers (T5 computes it in layer 0)."""

    def __init__(self, cfg: Seq2SeqConfig, bidirectional: bool, device=None, generator=None):
        super().__init__()
        self.cfg, self.bidirectional = cfg, bidirectional
        self.embedding = Embed(cfg.relative_attention_num_buckets, cfg.n_heads, torch.float32, cfg.param_dtype,
                               device, generator)

    def forward(self, q_positions: torch.Tensor, k_positions: torch.Tensor) -> torch.Tensor:
        """q_positions [b, t], k_positions [b, s], each in [0, max(t, s)) ->
        bias [b, h, t, s] f32."""
        cfg = self.cfg
        length = max(q_positions.shape[1], k_positions.shape[1])
        table = _bucket_table(length, self.bidirectional, cfg.relative_attention_num_buckets,
                              cfg.relative_attention_max_distance, str(k_positions.device))
        rel = k_positions[:, None, :] - q_positions[:, :, None]
        buckets = table[(rel + (length - 1)).clamp(0, 2 * length - 2)]
        return self.embedding(buckets).permute(0, 3, 1, 2).to(torch.float32)


def padding_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """[b, s] key validity -> [b, 1, 1, s] additive f32 bias."""
    return torch.where(key_mask[:, None, None, :].bool(), 0.0, -1e9).to(torch.float32)


class S2SAttention(nn.Module):
    """Self- or cross-attention. Cached self-attention writes this call's
    K/V into the layer's cache in place at `cache_index`; cross-attention
    reads K/V projected once at prefill (`project_kv`) as `precomputed_kv`."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.n_heads * cfg.head_dim
        lin = lambda i, o: Linear(i, o, cfg.use_bias, cfg.dtype, cfg.param_dtype, device, generator)
        self.q_proj = lin(cfg.d_model, inner)
        self.k_proj = lin(cfg.d_model, inner)
        self.v_proj = lin(cfg.d_model, inner)
        self.o_proj = lin(inner, cfg.d_model)

    def project_kv(self, x_kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, _ = x_kv.shape
        nh, hd = self.cfg.n_heads, self.cfg.head_dim
        return self.k_proj(x_kv).reshape(b, s, nh, hd), self.v_proj(x_kv).reshape(b, s, nh, hd)

    def forward(self, x_q, x_kv, attn_bias, precomputed_kv=None, layer_cache=None, cache_index: int = 0):
        """x_q [b, t, d]; x_kv None for self-attention; attn_bias [b, 1 or
        h, t, s] f32. Returns (out [b, t, d], the layer cache or None)."""
        cfg = self.cfg
        b, t, _ = x_q.shape
        nh, hd = cfg.n_heads, cfg.head_dim
        q = self.q_proj(x_q).reshape(b, t, nh, hd)
        if precomputed_kv is not None:
            k, v = precomputed_kv
        else:
            k, v = self.project_kv(x_kv if x_kv is not None else x_q)
        if layer_cache is not None:
            ck, cv = layer_cache["k"], layer_cache["v"]
            ck[:, cache_index:cache_index + t] = k.to(ck.dtype)
            cv[:, cache_index:cache_index + t] = v.to(cv.dtype)
            k, v = ck, cv
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        if cfg.attention_scale:
            scores = scores * (1.0 / np.sqrt(hd))
        probs = torch.softmax(scores + attn_bias, dim=-1).to(cfg.dtype)
        out = _einsum("bhts,bshd->bthd", probs, v).reshape(b, t, nh * hd)
        return self.o_proj(out), layer_cache


class S2SMLP(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        lin = lambda i, o: Linear(i, o, cfg.use_bias, cfg.dtype, cfg.param_dtype, device, generator)
        if cfg.glu:
            self.gate_proj = lin(cfg.d_model, cfg.d_ff)
        self.up_proj = lin(cfg.d_model, cfg.d_ff)
        self.down_proj = lin(cfg.d_ff, cfg.d_model)
        self.act = activation_fn(cfg)

    def forward(self, h):
        if self.cfg.glu:
            return self.down_proj(self.act(self.gate_proj(h)) * self.up_proj(h))
        return self.down_proj(self.act(self.up_proj(h)))


class EncoderBlock(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, device=None, generator=None):
        super().__init__()
        self.ln_attn = make_norm(cfg, device)
        self.attn = S2SAttention(cfg, device, generator)
        self.ln_mlp = make_norm(cfg, device)
        self.mlp = S2SMLP(cfg, device, generator)

    def forward(self, h, attn_bias):
        h = h + self.attn(self.ln_attn(h), None, attn_bias)[0]
        return h + self.mlp(self.ln_mlp(h))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, device=None, generator=None):
        super().__init__()
        self.ln_attn = make_norm(cfg, device)
        self.attn = S2SAttention(cfg, device, generator)
        self.ln_cross = make_norm(cfg, device)
        self.cross_attn = S2SAttention(cfg, device, generator)
        self.ln_mlp = make_norm(cfg, device)
        self.mlp = S2SMLP(cfg, device, generator)

    def forward(self, h, enc_h, self_bias, cross_bias, layer_cache=None, cache_index: int = 0, cross_kv=None):
        """enc_h [b, s, d], or None when the cross K/V come precomputed."""
        attn_out, new_cache = self.attn(self.ln_attn(h), None, self_bias, layer_cache=layer_cache,
                                        cache_index=cache_index)
        h = h + attn_out
        h = h + self.cross_attn(self.ln_cross(h), enc_h, cross_bias, precomputed_kv=cross_kv)[0]
        return h + self.mlp(self.ln_mlp(h)), new_cache


class Seq2SeqLM(nn.Module):
    """Encoder-decoder LM with hydra split support on the decoder stack.
    The methods read the submodules by name (`dec_block_i`, ...), so the
    frozen reference, which holds only some of them, runs them as well."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, cfg.param_dtype, device, generator)
        for i in range(cfg.n_encoder_layers):
            self.add_module(f"enc_block_{i}", EncoderBlock(cfg, device, generator))
        self.enc_ln_f = make_norm(cfg, device)
        for i in range(cfg.n_decoder_layers):
            self.add_module(f"dec_block_{i}", DecoderBlock(cfg, device, generator))
        self.dec_ln_f = make_norm(cfg, device)
        if cfg.relative_attention:
            self.enc_rel_bias = RelPosBias(cfg, True, device, generator)
            self.dec_rel_bias = RelPosBias(cfg, False, device, generator)
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab_size, False, cfg.dtype, cfg.param_dtype, device, generator)

    def encode(self, input_ids, attn_mask):
        """The encoder over left- or right-padded rows [b, s] -> [b, s, d]:
        the relative bias reads `position_ids(attn_mask)`, so left padding
        shifts it."""
        cfg = self.cfg
        pos = position_ids(attn_mask)
        bias = padding_bias(attn_mask)
        if cfg.relative_attention:
            bias = bias + self.enc_rel_bias(pos, pos)
        h = self.embed_tokens(input_ids)
        for i in range(cfg.n_encoder_layers):
            h = getattr(self, f"enc_block_{i}")(h, bias)
        return self.enc_ln_f(h)

    def unembed(self, h):
        """(logits, h_out): the final norm, `logit_scale` in the compute
        dtype (as a weak-typed JAX scalar rounds it), then the head."""
        cfg = self.cfg
        h_out = self.dec_ln_f(h)
        if cfg.logit_scale is not None:
            h_out = h_out * torch.tensor(cfg.logit_scale, dtype=h_out.dtype, device=h_out.device)
        if cfg.tie_embeddings:
            return self.embed_tokens.attend(h_out), h_out
        return self.lm_head(h_out), h_out

    def run_dec_blocks(self, h, enc_h, self_bias, cross_bias, start: int, stop: int, cache=None,
                       cache_index: int = 0, cross_kvs=None):
        new_layers = [] if cache is not None else None
        for i in range(start, stop):
            h, new_cache = getattr(self, f"dec_block_{i}")(
                h, enc_h, self_bias, cross_bias, layer_cache=None if cache is None else cache[i],
                cache_index=cache_index, cross_kv=None if cross_kvs is None else cross_kvs[i])
            if cache is not None:
                new_layers.append(new_cache)
        return h, new_layers

    def _decoder_biases(self, attn_mask, decoder_attn_mask):
        cfg = self.cfg
        self_bias = causal_bias(decoder_attn_mask)  # the JAX `causal_padding_bias`
        if cfg.relative_attention:
            dec_pos = position_ids(decoder_attn_mask)
            self_bias = self_bias + self.dec_rel_bias(dec_pos, dec_pos)
        return self_bias, padding_bias(attn_mask)

    def forward(self, input_ids, attn_mask, decoder_input_ids, decoder_attn_mask, split: int = 0):
        """Returns (logits, dec_h_split, dec_h_final, enc_h)."""
        enc_h = self.encode(input_ids, attn_mask)
        self_bias, cross_bias = self._decoder_biases(attn_mask, decoder_attn_mask)
        h = self.embed_tokens(decoder_input_ids)
        h, _ = self.run_dec_blocks(h, enc_h, self_bias, cross_bias, 0, split)
        h_split = h
        h, _ = self.run_dec_blocks(h, enc_h, self_bias, cross_bias, split, self.cfg.n_decoder_layers)
        logits, h_final = self.unembed(h)
        return logits, h_split, h_final, enc_h

    def forward_from(self, h_split, enc_h, attn_mask, decoder_attn_mask, start_layer: int = 0):
        """Logits of the decoder resumed at block `start_layer` from its
        input there and the encoder's output (the frozen branch)."""
        self_bias, cross_bias = self._decoder_biases(attn_mask, decoder_attn_mask)
        h, _ = self.run_dec_blocks(h_split, enc_h, self_bias, cross_bias, start_layer, self.cfg.n_decoder_layers)
        return self.unembed(h)[0]

    def prepare_cache(self, enc_h, enc_mask, max_len: int):
        """The decode cache: an empty self-attention K/V of `max_len`
        columns a decoder layer, and the cross K/V projected once from the
        encoder's output."""
        cfg = self.cfg
        b, device = enc_h.shape[0], enc_h.device
        shape = (b, max_len, cfg.n_heads, cfg.head_dim)
        layers, cross = [], []
        for i in range(cfg.n_decoder_layers):
            layers.append({"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                           "v": torch.zeros(shape, dtype=cfg.dtype, device=device)})
            ck, cv = getattr(self, f"dec_block_{i}").cross_attn.project_kv(enc_h)
            cross.append({"k": ck, "v": cv})
        return {
            "index": 0,
            "mask": torch.zeros((b, max_len), dtype=torch.int32, device=device),
            "pos": torch.zeros((b,), dtype=torch.int64, device=device),
            "enc_mask": enc_mask.to(torch.int32),
            "layers": layers,
            "cross": cross,
        }

    def decode_step(self, tokens, cache: Dict[str, Any], token_mask):
        """One cached decoder call over [b, t] tokens (the encoder is in the
        cache). The rows have no left padding: slot j holds position j, so
        the relative bias reads the query at `index + j` and the key at its
        slot. Returns (logits, h_final, new_cache); the K/V and the mask are
        written in place."""
        cfg = self.cfg
        b, t = tokens.shape
        index = int(cache["index"])
        S = cache["mask"].shape[-1]
        new_mask = cache["mask"].clone()
        new_mask[:, index:index + t] = token_mask.to(new_mask.dtype)
        q_pos = (index + torch.arange(t, device=tokens.device))[None, :].expand(b, t)
        k_pos = torch.arange(S, device=tokens.device)[None, :].expand(b, S)
        self_bias = padding_bias(new_mask)
        # causal within the incoming block, and no future cache slot
        within = k_pos[:, None, None, :] > q_pos[:, None, :, None]
        self_bias = self_bias + torch.where(within, -1e9, 0.0).to(torch.float32)
        if cfg.relative_attention:
            self_bias = self_bias + self.dec_rel_bias(q_pos, k_pos)
        cross_bias = padding_bias(cache["enc_mask"])
        cross_kvs = [(c["k"], c["v"]) for c in cache["cross"]]
        h = self.embed_tokens(tokens)
        h, new_layers = self.run_dec_blocks(h, None, self_bias, cross_bias, 0, cfg.n_decoder_layers,
                                            cache=cache["layers"], cache_index=index, cross_kvs=cross_kvs)
        logits, h_final = self.unembed(h)
        new_cache = {
            "index": index + t,
            "mask": new_mask,
            "pos": cache["pos"] + token_mask.sum(-1).to(torch.int64),
            "enc_mask": cache["enc_mask"],
            "layers": new_layers,
            "cross": cache["cross"],
        }
        return logits, h_final, new_cache


class Seq2SeqLMWithValueHead(nn.Module):
    """The value head over the decoder's final hidden state (after the
    final norm and `logit_scale`, as JAX reads it)."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.lm = Seq2SeqLM(cfg, device, generator)
        self.v_head = MLPHead(cfg.d_model, 1, cfg.dtype, cfg.param_dtype, device, generator)

    def forward(self, input_ids, attn_mask, decoder_input_ids, decoder_attn_mask, split: int = 0):
        """Returns (logits, values, h_split, enc_h)."""
        logits, h_split, h_final, enc_h = self.lm(input_ids, attn_mask, decoder_input_ids, decoder_attn_mask,
                                                  split)
        return logits, self.v_head(h_final)[..., 0], h_split, enc_h

    def encode(self, input_ids, attn_mask):
        return self.lm.encode(input_ids, attn_mask)

    def prepare_cache(self, enc_h, enc_mask, max_len: int):
        return self.lm.prepare_cache(enc_h, enc_mask, max_len)

    def decode_step(self, tokens, cache, token_mask, is_prefill: bool = False, with_value: bool = False):
        """Returns (logits, values or None, new_cache)."""
        logits, h, new_cache = self.lm.decode_step(tokens, cache, token_mask)
        return logits, self.v_head(h)[..., 0] if with_value else None, new_cache


class Seq2SeqLMWithILQLHeads(nn.Module):
    """ILQL's heads (`ILQLHeads`) over the decoder's final hidden state."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, generator=None, two_qs: bool = True):
        super().__init__()
        self.cfg = cfg
        self.lm = Seq2SeqLM(cfg, device, generator)
        self.ilql_heads = ILQLHeads(cfg.d_model, cfg.vocab_size, two_qs, cfg.dtype, cfg.param_dtype, device,
                                    generator)

    def forward(self, input_ids, attn_mask, decoder_input_ids, decoder_attn_mask, states_ixs=None,
                actions_ixs=None):
        """Returns (logits, qs, target_qs, vs, h_final)."""
        logits, _, h_final, _ = self.lm(input_ids, attn_mask, decoder_input_ids, decoder_attn_mask, 0)
        qs, target_qs, vs = self.ilql_heads(h_final, states_ixs, actions_ixs)
        return logits, qs, target_qs, vs, h_final

    def encode(self, input_ids, attn_mask):
        return self.lm.encode(input_ids, attn_mask)

    def prepare_cache(self, enc_h, enc_mask, max_len: int):
        return self.lm.prepare_cache(enc_h, enc_mask, max_len)

    def decode_step(self, tokens, cache, token_mask, is_prefill: bool = False):
        """Returns (logits, qs, target_qs, vs, new_cache): what the
        sampler's beta * (Q - V) shift reads."""
        logits, h, new_cache = self.lm.decode_step(tokens, cache, token_mask)
        qs, target_qs, vs = self.ilql_heads(h)
        return logits, qs, target_qs, vs, new_cache


class Seq2SeqHydraReference(Seq2SeqLM):
    """PPO's frozen reference: copies, taken once, of the decoder blocks
    [split, n), the decoder's final norm, its relative-bias table and the
    unembedding (the tied embedding or the head), or of the whole LM at
    split 0. Submodules carry the LM's names, so the state dict has the
    JAX subtree's paths; they never take a gradient."""

    def __init__(self, lm: Seq2SeqLM, split: int):
        nn.Module.__init__(self)
        cfg = self.cfg = lm.cfg
        self.split = split
        if split == 0:
            names = [name for name, _ in lm.named_children()]
        else:
            names = [f"dec_block_{i}" for i in range(split, cfg.n_decoder_layers)] + ["dec_ln_f"]
            names += ["dec_rel_bias"] if cfg.relative_attention else []
            names += ["embed_tokens" if cfg.tie_embeddings else "lm_head"]
        for name in names:
            self.add_module(name, copy.deepcopy(getattr(lm, name)))
        self.requires_grad_(False)


def forward_seq2seq_policy_and_ref(model: Seq2SeqLMWithValueHead, ref: Seq2SeqHydraReference, input_ids,
                                   attn_mask, decoder_input_ids, decoder_attn_mask):
    """Policy logits and values and the frozen reference's logits: the
    reference resumes the decoder at its split from the policy's
    activation there and the encoder's output, or runs a whole pass of
    its own at split 0. Returns (logits, values, ref_logits)."""
    logits, values, h_split, enc_h = model(input_ids, attn_mask, decoder_input_ids, decoder_attn_mask, ref.split)
    if ref.split > 0:
        ref_logits = ref.forward_from(h_split.detach(), enc_h.detach(), attn_mask, decoder_attn_mask, ref.split)
    else:
        ref_logits = ref(input_ids, attn_mask, decoder_input_ids, decoder_attn_mask, 0)[0]
    return logits, values, ref_logits.detach()


def seq2seq_trainable_mask(model: nn.Module, cfg: Seq2SeqConfig, num_layers_unfrozen: int) -> Dict[str, bool]:
    """{parameter name: trainable}: the heads always; in the LM, -1 = all,
    0 = none, k > 0 = the top k decoder blocks and the decoder's final
    norm. The encoder and the embeddings stay frozen (the reference's
    freeze_bottom_seq2seq_layers)."""
    split = cfg.n_decoder_layers - num_layers_unfrozen if num_layers_unfrozen > 0 else 0

    def _trainable(name: str) -> bool:
        parts = name.split(".")
        if parts[0] != "lm" or num_layers_unfrozen == -1:
            return True
        if num_layers_unfrozen == 0:
            return False
        if parts[1].startswith("dec_block_"):
            return int(parts[1].split("_")[-1]) >= max(split, 0)
        return parts[1] == "dec_ln_f"

    return {name: _trainable(name) for name, _ in model.named_parameters()}


SEQ2SEQ_PRESETS: Dict[str, Dict[str, Any]] = {
    "t5-tiny": dict(d_model=64, n_encoder_layers=2, n_decoder_layers=2, n_heads=4, d_ff=256, max_seq_len=256),
    "t5-small": dict(d_model=512, n_encoder_layers=6, n_decoder_layers=6, n_heads=8, d_ff=2048, max_seq_len=512),
    "t5-base": dict(d_model=768, n_encoder_layers=12, n_decoder_layers=12, n_heads=12, d_ff=3072,
                    max_seq_len=512),
    "flan-t5-small": dict(d_model=512, n_encoder_layers=8, n_decoder_layers=8, n_heads=6, d_kv=64, d_ff=1024,
                          max_seq_len=512, activation="gelu", glu=True, tie_embeddings=False),
}


def seq2seq_config_from_preset(name: str, vocab_size: int, **overrides) -> Seq2SeqConfig:
    if name not in SEQ2SEQ_PRESETS:
        raise ValueError(f"Unknown seq2seq preset '{name}'. Available: {sorted(SEQ2SEQ_PRESETS)}")
    kwargs = dict(SEQ2SEQ_PRESETS[name])
    kwargs.update(overrides)
    return Seq2SeqConfig(vocab_size=vocab_size, **kwargs)
