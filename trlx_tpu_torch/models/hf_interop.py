"""HF checkpoint interop (port of the JAX package's `models/hf_interop.py`):
build a TransformerConfig (a Seq2SeqConfig for t5) from a local
directory's `config.json`, load its weights (`pytorch_model.bin`, its
sharded index, or safetensors where the `safetensors` package imports)
into the policy's state dict, and export the policy back to that layout
(`save_pretrained`). Families: GPT2LMHeadModel, LlamaForCausalLM (and
MistralForCausalLM, its sliding window), GPTNeoXForCausalLM (pythia),
GPTJForCausalLM, OPTForCausalLM, BloomForCausalLM, GPTBigCodeForCausalLM
and T5ForConditionalGeneration (t5 v1.0: relu, tied, logits scaled by
d_model**-0.5; v1.1/flan-t5 and mt5: gated gelu, an untied head), whose
per-stack relative-bias table HF keeps in block 0's self-attention.
A config with MoE blocks is refused both ways: the JAX package has no HF
layout for the expert tensors either (its export fails on them), so
`save_pretrained` writes such a model's raw state dict instead.
Nothing is downloaded and `transformers` is not imported: a model path is
a local directory, read with json and torch.

The port's parameters carry the JAX tree's names with torch layouts
(`lm.block_0.attn.q_proj.weight` is the JAX kernel transposed, [out, in]
as HF's Linear weights are), so load and export read and write the
module's state dict directly. Rotary convention: the model rotates
half-split ("rotate_half") pairs; GPT-J checkpoints rotate interleaved
pairs, so their q/k projection rows are permuted within the rotary dims
at load and back at export (exact, no runtime cost).
"""

import json
import os
from typing import Dict, Union

import numpy as np
import torch

from trlx_tpu_torch.models.lora import is_adapter_name
from trlx_tpu_torch.models.seq2seq import Seq2SeqConfig
from trlx_tpu_torch.models.transformer import TransformerConfig

_MOE = ("MoE blocks have no HF checkpoint layout: the JAX package maps no expert tensors to HF names "
        "(moe_experts must be 0 to load or export an HF directory)")


def _check_dense(cfg: TransformerConfig, what: str) -> None:
    if cfg.moe_experts > 0:
        raise NotImplementedError(f"{what}: {_MOE}")


def _read_hf_config(path: str) -> Dict:
    """The directory's `config.json`. There is no hub or `transformers`
    fallback: a model path must be a local directory holding one."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"no config.json under '{path}': model_path must be a local HF checkpoint "
                                "directory (or random:<preset>)")
    with open(cfg_path) as f:
        return json.load(f)


def _family_of(hf: Dict) -> str:
    """The checkpoint's family from its `architectures` and `model_type`,
    by the JAX package's rules (exact t5/mt5 matches, then substrings)."""
    arch = ((hf.get("architectures") or [""])[0] or "").lower()
    mt = hf.get("model_type", "")
    if mt in ("t5", "mt5") or arch in ("t5forconditionalgeneration", "mt5forconditionalgeneration"):
        return "t5"
    for fam, keys in (
        ("gpt_bigcode", ("bigcode",)),
        ("gpt_neox", ("neox",)),
        ("gptj", ("gptj",)),
        ("gpt2", ("gpt2",)),
        ("llama", ("llama", "mistral")),
        ("opt", ("optfor",)),
        ("bloom", ("bloom",)),
    ):
        if any(k in arch for k in keys) or mt == fam:
            return fam
    raise ValueError(f"Unsupported HF architecture for conversion: {arch or mt}")


def _seq2seq_config_from_hf(hf: Dict, **overrides) -> Seq2SeqConfig:
    """HF T5Config -> Seq2SeqConfig, by the JAX package's rules: t5 v1.0
    (relu, tied embeddings, logits scaled by d_model**-0.5), v1.1/flan-t5
    and mt5 (gated gelu, an untied head, no logit scale); HF-T5 folds the
    1/sqrt(d_kv) into its init, so `attention_scale` is off."""
    ffp = hf.get("feed_forward_proj", "relu")
    gated = ffp.startswith("gated-")
    # HF forces gelu_new (the tanh form, our "gelu") only for gated-gelu;
    # a plain 'gelu' runs the exact erf form
    act = {"relu": "relu", "gelu": "gelu" if gated else "gelu_exact", "gelu_new": "gelu",
           "silu": "silu"}[ffp.split("-")[-1]]
    tie = bool(hf.get("tie_word_embeddings", True))
    kwargs = dict(
        vocab_size=hf["vocab_size"], d_model=hf["d_model"], n_encoder_layers=hf["num_layers"],
        n_decoder_layers=hf.get("num_decoder_layers") or hf["num_layers"], n_heads=hf["num_heads"],
        d_kv=hf.get("d_kv"), d_ff=hf["d_ff"],
        # T5 has no position cap (the relative bias saturates); 512 is the
        # tokenizers' model_max_length convention
        max_seq_len=512, norm="rmsnorm", activation=act, glu=gated, tie_embeddings=tie, use_bias=False,
        relative_attention=True,
        relative_attention_num_buckets=hf.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=hf.get("relative_attention_max_distance", 128),
        decoder_start_token_id=hf.get("decoder_start_token_id", 0) or 0,
        pad_token_id=hf.get("pad_token_id", 0), eos_token_id=hf.get("eos_token_id", 1),
        layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-6), attention_scale=False,
        logit_scale=hf["d_model"] ** -0.5 if tie else None, hf_family="t5",
    )
    kwargs.update(overrides)
    return Seq2SeqConfig(**kwargs)


def config_from_hf(path: str, **overrides) -> Union[TransformerConfig, Seq2SeqConfig]:
    """A TransformerConfig (a Seq2SeqConfig for t5) from the directory's
    `config.json` (`overrides` win, as `model_extra_configs` do for
    presets)."""
    hf = _read_hf_config(path)
    fam = _family_of(hf)
    if fam == "t5":
        return _seq2seq_config_from_hf(hf, **overrides)
    if fam == "gpt2":
        kwargs = dict(
            vocab_size=hf["vocab_size"], d_model=hf["n_embd"], n_layers=hf["n_layer"],
            n_heads=hf["n_head"], d_ff=hf.get("n_inner") or 4 * hf["n_embd"],
            max_seq_len=hf["n_positions"], pos_embed="learned", norm="layernorm",
            activation="gelu", glu=False,
            tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
            use_bias=True,
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
        )
    elif fam == "llama":
        kwargs = dict(
            vocab_size=hf["vocab_size"], d_model=hf["hidden_size"],
            n_layers=hf["num_hidden_layers"], n_heads=hf["num_attention_heads"],
            n_kv_heads=hf.get("num_key_value_heads"), d_ff=hf["intermediate_size"],
            max_seq_len=hf.get("max_position_embeddings", 4096), pos_embed="rope",
            norm="rmsnorm", activation="silu", glu=True,
            tie_embeddings=bool(hf.get("tie_word_embeddings", False)), use_bias=False,
            rope_theta=hf.get("rope_theta", 10000.0),
            layer_norm_epsilon=hf.get("rms_norm_eps", 1e-6),
            # Mistral: banded causal attention; plain Llama leaves it None
            sliding_window=hf.get("sliding_window"),
        )
    elif fam == "gpt_neox":
        kwargs = dict(
            vocab_size=hf["vocab_size"], d_model=hf["hidden_size"],
            n_layers=hf["num_hidden_layers"], n_heads=hf["num_attention_heads"],
            d_ff=hf["intermediate_size"], max_seq_len=hf["max_position_embeddings"],
            pos_embed="rope", rotary_pct=hf.get("rotary_pct", 1.0),
            rope_theta=hf.get("rotary_emb_base", 10000.0),
            norm="layernorm", activation="gelu_exact" if hf.get("hidden_act", "gelu") == "gelu" else "gelu",
            parallel_residual=bool(hf.get("use_parallel_residual", True)),
            tie_embeddings=bool(hf.get("tie_word_embeddings", False)), use_bias=True,
            layer_norm_epsilon=hf.get("layer_norm_eps", 1e-5),
        )
    elif fam == "gptj":
        hd = hf["n_embd"] // hf["n_head"]
        kwargs = dict(
            vocab_size=hf["vocab_size"], d_model=hf["n_embd"], n_layers=hf["n_layer"],
            n_heads=hf["n_head"], d_ff=hf.get("n_inner") or 4 * hf["n_embd"],
            max_seq_len=hf["n_positions"], pos_embed="rope",
            rotary_pct=(hf.get("rotary_dim") or hd) / hd,
            norm="layernorm", activation="gelu",
            parallel_residual=True, shared_ln=True,
            tie_embeddings=False, attn_bias=False, lm_head_bias=True, use_bias=True,
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
        )
    elif fam == "opt":
        if not hf.get("do_layer_norm_before", True):
            raise ValueError("OPT variants with do_layer_norm_before=False (350m) are unsupported")
        if hf.get("word_embed_proj_dim", hf["hidden_size"]) != hf["hidden_size"]:
            raise ValueError("OPT word_embed_proj_dim != hidden_size is unsupported")
        kwargs = dict(
            vocab_size=hf["vocab_size"], d_model=hf["hidden_size"],
            n_layers=hf["num_hidden_layers"], n_heads=hf["num_attention_heads"],
            d_ff=hf["ffn_dim"], max_seq_len=hf["max_position_embeddings"],
            pos_embed="learned", pos_offset=2, norm="layernorm",
            activation="relu" if hf.get("activation_function", "relu") == "relu" else "gelu",
            tie_embeddings=True, use_bias=True,
            layer_norm_epsilon=1e-5,
        )
    elif fam == "bloom":
        kwargs = dict(
            vocab_size=hf["vocab_size"], d_model=hf["hidden_size"],
            n_layers=hf["n_layer"], n_heads=hf["n_head"], d_ff=4 * hf["hidden_size"],
            max_seq_len=2048, pos_embed="none", alibi=True, embed_ln=True,
            norm="layernorm", activation="gelu", tie_embeddings=True, use_bias=True,
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
        )
    else:  # gpt_bigcode
        kwargs = dict(
            vocab_size=hf["vocab_size"], d_model=hf["n_embd"], n_layers=hf["n_layer"],
            n_heads=hf["n_head"], n_kv_heads=1 if hf.get("multi_query", True) else None,
            d_ff=hf.get("n_inner") or 4 * hf["n_embd"], max_seq_len=hf["n_positions"],
            pos_embed="learned", norm="layernorm", activation="gelu",
            tie_embeddings=True, use_bias=True,
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
        )
    kwargs["hf_family"] = fam
    kwargs.update(overrides)
    return TransformerConfig(**kwargs)


def _load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The directory's HF weights as f32 CPU tensors: `model.safetensors`
    or its sharded index (where the `safetensors` package imports, else a
    refusal naming the file), `pytorch_model.bin` or its sharded index."""
    st_index = os.path.join(path, "model.safetensors.index.json")
    bin_index = os.path.join(path, "pytorch_model.bin.index.json")
    if os.path.exists(os.path.join(path, "model.safetensors")):
        files = [os.path.join(path, "model.safetensors")]
    elif os.path.exists(st_index):
        with open(st_index) as f:
            files = sorted({os.path.join(path, v) for v in json.load(f)["weight_map"].values()})
    elif os.path.exists(os.path.join(path, "pytorch_model.bin")):
        files = [os.path.join(path, "pytorch_model.bin")]
    elif os.path.exists(bin_index):
        with open(bin_index) as f:
            files = sorted({os.path.join(path, v) for v in json.load(f)["weight_map"].values()})
    else:
        raise FileNotFoundError(f"No model weights found under {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for f in files:
        if f.endswith(".safetensors"):
            try:
                from safetensors.torch import load_file
            except ImportError as e:
                raise NotImplementedError(f"{f} needs the `safetensors` package, which does not import here; "
                                          "export the checkpoint as pytorch_model.bin") from e
            sd = load_file(f)
        else:
            sd = torch.load(f, map_location="cpu", weights_only=True)
        tensors.update({k: v.float() for k, v in sd.items()})
    return tensors


def _strip_prefix(sd: Dict, *prefixes: str) -> Dict:
    """Drop a leading wrapper prefix (`transformer.`, `model.decoder.`) if
    any key carries it."""
    for p in prefixes:
        if any(k.startswith(p) for k in sd):
            return {k[len(p):] if k.startswith(p) else k: v for k, v in sd.items()}
    return sd


def _gptj_rope_perm(rd: int) -> np.ndarray:
    """Permutation from the interleaved rotary layout to the half-split
    one: target dim i reads source dim 2i (first half) or 2(i - rd/2) + 1
    (second half)."""
    half = rd // 2
    return np.concatenate([np.arange(half) * 2, np.arange(half) * 2 + 1])


def _permute_rotary_cols(w, cfg: TransformerConfig, n_heads: int, inverse: bool = False):
    """Permute a projection's output dims (the rows of a torch [heads*hd,
    in] weight, the columns of the JAX kernel) from the interleaved to the
    half-split rotary convention, or back with `inverse`."""
    rd, hd = cfg.rotary_dim, cfg.head_dim
    perm = _gptj_rope_perm(rd)
    if inverse:
        perm = np.argsort(perm)
    w = w.reshape((n_heads, hd) + tuple(w.shape[1:])).clone()
    w[:, :rd] = w[:, torch.from_numpy(perm)]
    return w.reshape((n_heads * hd,) + tuple(w.shape[2:]))


def _split_fused_qkv_per_head(qkv, n_heads: int, head_dim: int):
    """Split a fused projection whose outputs are laid out per head as
    (q, k, v) triples (GPT-NeoX, Bloom): a [heads*3*hd, in] weight or a
    [heads*3*hd] bias -> q, k, v of [heads*hd, ...]."""
    rest = tuple(qkv.shape[1:])
    x = qkv.reshape((n_heads, 3, head_dim) + rest)
    return tuple(x[:, i].reshape((n_heads * head_dim,) + rest) for i in range(3))


def _fuse_qkv_per_head(q, k, v, n_heads: int, head_dim: int):
    """Inverse of `_split_fused_qkv_per_head` on numpy arrays."""
    rest = q.shape[1:]
    stack = np.stack([x.reshape((n_heads, head_dim) + rest) for x in (q, k, v)], axis=1)
    return stack.reshape((n_heads * 3 * head_dim,) + rest)


# ---------------------------------------------------------------------------
# Per-family loaders: HF state dict -> the LM's state dict (names under lm.)
# ---------------------------------------------------------------------------


def _copy(lm: Dict, ours: str, sd: Dict, theirs: str, bias: bool = True) -> None:
    """A norm, or an HF Linear ([out, in], the port's layout), as it is."""
    lm[ours + ".weight"] = sd[theirs + ".weight"]
    if bias:
        lm[ours + ".bias"] = sd[theirs + ".bias"]


def _qkv(lm: Dict, b: str, ws, bs=None) -> None:
    for n, i in zip(("q_proj", "k_proj", "v_proj"), range(3)):
        lm[b + f"attn.{n}.weight"] = ws[i]
        if bs is not None:
            lm[b + f"attn.{n}.bias"] = bs[i]


def _load_gpt2(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """GPT-2's Conv1D weights are [in, out]: the port's Linear weight is
    their transpose; the fused c_attn splits into q, k, v."""
    sd = _strip_prefix(sd, "transformer.")
    lm = {"embed_tokens.weight": sd["wte.weight"], "embed_pos.weight": sd["wpe.weight"]}
    _copy(lm, "ln_f", sd, "ln_f")
    for i in range(cfg.n_layers):
        p, b = f"h.{i}.", f"block_{i}."
        _copy(lm, b + "ln_attn", sd, p + "ln_1")
        _copy(lm, b + "ln_mlp", sd, p + "ln_2")
        _qkv(lm, b, [w.t() for w in torch.chunk(sd[p + "attn.c_attn.weight"], 3, dim=1)],
             torch.chunk(sd[p + "attn.c_attn.bias"], 3, dim=0))
        for ours, theirs in (("attn.o_proj", "attn.c_proj"), ("mlp.up_proj", "mlp.c_fc"),
                             ("mlp.down_proj", "mlp.c_proj")):
            lm[b + ours + ".weight"] = sd[p + theirs + ".weight"].t()
            lm[b + ours + ".bias"] = sd[p + theirs + ".bias"]
    return lm


def _load_llama(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    lm = {"embed_tokens.weight": sd[f"{pre}embed_tokens.weight"], "ln_f.weight": sd[f"{pre}norm.weight"]}
    for i in range(cfg.n_layers):
        p, b = f"{pre}layers.{i}.", f"block_{i}."
        lm[b + "ln_attn.weight"] = sd[p + "input_layernorm.weight"]
        lm[b + "ln_mlp.weight"] = sd[p + "post_attention_layernorm.weight"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            lm[b + f"attn.{n}.weight"] = sd[p + f"self_attn.{n}.weight"]
        for n in ("gate_proj", "up_proj", "down_proj"):
            lm[b + f"mlp.{n}.weight"] = sd[p + f"mlp.{n}.weight"]
    if not cfg.tie_embeddings:
        lm["lm_head.weight"] = sd["lm_head.weight"]
    return lm


def _load_gpt_neox(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    sd = _strip_prefix(sd, "gpt_neox.")
    lm = {"embed_tokens.weight": sd["embed_in.weight"], "lm_head.weight": sd["embed_out.weight"]}
    _copy(lm, "ln_f", sd, "final_layer_norm")
    for i in range(cfg.n_layers):
        p, b = f"layers.{i}.", f"block_{i}."
        _copy(lm, b + "ln_attn", sd, p + "input_layernorm")
        _copy(lm, b + "ln_mlp", sd, p + "post_attention_layernorm")
        _qkv(lm, b, _split_fused_qkv_per_head(sd[p + "attention.query_key_value.weight"], cfg.n_heads, cfg.head_dim),
             _split_fused_qkv_per_head(sd[p + "attention.query_key_value.bias"], cfg.n_heads, cfg.head_dim))
        _copy(lm, b + "attn.o_proj", sd, p + "attention.dense")
        _copy(lm, b + "mlp.up_proj", sd, p + "mlp.dense_h_to_4h")
        _copy(lm, b + "mlp.down_proj", sd, p + "mlp.dense_4h_to_h")
    return lm


def _load_gptj(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    sd = _strip_prefix(sd, "transformer.")
    lm = {"embed_tokens.weight": sd["wte.weight"]}
    _copy(lm, "ln_f", sd, "ln_f")
    _copy(lm, "lm_head", sd, "lm_head")
    for i in range(cfg.n_layers):
        p, b = f"h.{i}.", f"block_{i}."
        _copy(lm, b + "ln_attn", sd, p + "ln_1")
        lm[b + "attn.q_proj.weight"] = _permute_rotary_cols(sd[p + "attn.q_proj.weight"], cfg, cfg.n_heads)
        lm[b + "attn.k_proj.weight"] = _permute_rotary_cols(sd[p + "attn.k_proj.weight"], cfg, cfg.kv_heads)
        _copy(lm, b + "attn.v_proj", sd, p + "attn.v_proj", bias=False)
        _copy(lm, b + "attn.o_proj", sd, p + "attn.out_proj", bias=False)
        _copy(lm, b + "mlp.up_proj", sd, p + "mlp.fc_in")
        _copy(lm, b + "mlp.down_proj", sd, p + "mlp.fc_out")
    return lm


def _load_opt(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    sd = _strip_prefix(sd, "model.decoder.", "decoder.")
    lm = {"embed_tokens.weight": sd["embed_tokens.weight"], "embed_pos.weight": sd["embed_positions.weight"]}
    _copy(lm, "ln_f", sd, "final_layer_norm")
    for i in range(cfg.n_layers):
        p, b = f"layers.{i}.", f"block_{i}."
        _copy(lm, b + "ln_attn", sd, p + "self_attn_layer_norm")
        _copy(lm, b + "ln_mlp", sd, p + "final_layer_norm")
        for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                             ("o_proj", "out_proj")):
            _copy(lm, b + f"attn.{ours}", sd, p + f"self_attn.{theirs}")
        _copy(lm, b + "mlp.up_proj", sd, p + "fc1")
        _copy(lm, b + "mlp.down_proj", sd, p + "fc2")
    return lm


def _load_bloom(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    sd = _strip_prefix(sd, "transformer.")
    lm = {"embed_tokens.weight": sd["word_embeddings.weight"]}
    _copy(lm, "ln_embed", sd, "word_embeddings_layernorm")
    _copy(lm, "ln_f", sd, "ln_f")
    for i in range(cfg.n_layers):
        p, b = f"h.{i}.", f"block_{i}."
        _copy(lm, b + "ln_attn", sd, p + "input_layernorm")
        _copy(lm, b + "ln_mlp", sd, p + "post_attention_layernorm")
        _qkv(lm, b,
             _split_fused_qkv_per_head(sd[p + "self_attention.query_key_value.weight"], cfg.n_heads, cfg.head_dim),
             _split_fused_qkv_per_head(sd[p + "self_attention.query_key_value.bias"], cfg.n_heads, cfg.head_dim))
        _copy(lm, b + "attn.o_proj", sd, p + "self_attention.dense")
        _copy(lm, b + "mlp.up_proj", sd, p + "mlp.dense_h_to_4h")
        _copy(lm, b + "mlp.down_proj", sd, p + "mlp.dense_4h_to_h")
    return lm


def _load_gpt_bigcode(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """GPTBigCode's Linear weights are [out, in]; the fused c_attn's
    outputs are [q (d), k (kv), v (kv)]."""
    sd = _strip_prefix(sd, "transformer.")
    d, kv = cfg.d_model, cfg.kv_heads * cfg.head_dim
    lm = {"embed_tokens.weight": sd["wte.weight"], "embed_pos.weight": sd["wpe.weight"]}
    _copy(lm, "ln_f", sd, "ln_f")
    for i in range(cfg.n_layers):
        p, b = f"h.{i}.", f"block_{i}."
        _copy(lm, b + "ln_attn", sd, p + "ln_1")
        _copy(lm, b + "ln_mlp", sd, p + "ln_2")
        w, bias = sd[p + "attn.c_attn.weight"], sd[p + "attn.c_attn.bias"]
        _qkv(lm, b, (w[:d], w[d:d + kv], w[d + kv:]), (bias[:d], bias[d:d + kv], bias[d + kv:]))
        _copy(lm, b + "attn.o_proj", sd, p + "attn.c_proj")
        _copy(lm, b + "mlp.up_proj", sd, p + "mlp.c_fc")
        _copy(lm, b + "mlp.down_proj", sd, p + "mlp.c_proj")
    return lm


_T5_ATTN = ("q", "k", "v", "o")


def _t5_mlp_names(cfg: Seq2SeqConfig):
    """(ours, theirs) of the T5 MLP's projections: the gated form's wi_0 is
    the gate and wi_1 the up projection."""
    if cfg.glu:
        return (("gate_proj", "wi_0"), ("up_proj", "wi_1"), ("down_proj", "wo"))
    return (("up_proj", "wi"), ("down_proj", "wo"))


def _t5_names(cfg: Seq2SeqConfig):
    """(ours under `lm.`, theirs) for every T5 tensor but the head: the HF
    Linear weights have the port's [out, in] layout, so each maps as it is.
    The per-stack relative-bias table lives in block 0's self-attention
    (HF computes it there and shares it)."""
    rel = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    names = [("embed_tokens.weight", "shared.weight"),
             ("enc_ln_f.weight", "encoder.final_layer_norm.weight"),
             ("dec_ln_f.weight", "decoder.final_layer_norm.weight"),
             ("enc_rel_bias.embedding.weight", "encoder." + rel),
             ("dec_rel_bias.embedding.weight", "decoder." + rel)]
    for stack, n, layers in (("enc", cfg.n_encoder_layers, (("attn", "SelfAttention"), ("mlp", None))),
                             ("dec", cfg.n_decoder_layers,
                              (("attn", "SelfAttention"), ("cross_attn", "EncDecAttention"), ("mlp", None)))):
        for i in range(n):
            b, p = f"{stack}_block_{i}.", f"{'encoder' if stack == 'enc' else 'decoder'}.block.{i}.layer."
            for j, (ours, theirs) in enumerate(layers):
                ln = {"attn": "ln_attn", "cross_attn": "ln_cross", "mlp": "ln_mlp"}[ours]
                names.append((b + ln + ".weight", f"{p}{j}.layer_norm.weight"))
                if ours == "mlp":
                    names += [(f"{b}mlp.{o}.weight", f"{p}{j}.DenseReluDense.{t}.weight")
                              for o, t in _t5_mlp_names(cfg)]
                else:
                    names += [(f"{b}{ours}.{x}_proj.weight", f"{p}{j}.{theirs}.{x}.weight") for x in _T5_ATTN]
    return names


def _load_t5(sd: Dict[str, torch.Tensor], cfg: Seq2SeqConfig) -> Dict[str, torch.Tensor]:
    lm = {ours: sd[theirs] for ours, theirs in _t5_names(cfg)}
    if not cfg.tie_embeddings:
        lm["lm_head.weight"] = sd["lm_head.weight"]
    return lm


_LOADERS = {
    "t5": _load_t5,
    "gpt2": _load_gpt2,
    "llama": _load_llama,
    "gpt_neox": _load_gpt_neox,
    "gptj": _load_gptj,
    "opt": _load_opt,
    "bloom": _load_bloom,
    "gpt_bigcode": _load_gpt_bigcode,
}


def load_params_from_hf(path: str, cfg: TransformerConfig,
                        state_template: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The template state dict with every base `lm.*` entry replaced by the
    directory's weights, in the template's dtype and device (a shape that
    differs raises). Entries outside the LM (the value head) and the
    adapters (LoRA factors, the soft prompt, the prefixes: an HF base
    checkpoint has none) keep the template's fresh init, as in the JAX
    package."""
    _check_dense(cfg, f"loading '{path}'")
    hf = _read_hf_config(path)
    fam = _family_of(hf)
    lm = _LOADERS[fam](_load_state_dict(path), cfg)
    out = dict(state_template)
    for name, tpl in state_template.items():
        if not name.startswith("lm.") or is_adapter_name(name):
            continue
        if name[3:] not in lm:
            raise KeyError(f"{name} has no counterpart in the {fam} checkpoint at {path}")
        w = lm[name[3:]]
        if tuple(w.shape) != tuple(tpl.shape):
            raise ValueError(f"Converted weight {name} has shape {tuple(w.shape)} != expected {tuple(tpl.shape)}")
        out[name] = w.to(dtype=tpl.dtype, device=tpl.device).contiguous()
    return out


# ---------------------------------------------------------------------------
# Export: the policy's state dict -> an HF-layout state dict (f32 numpy)
# ---------------------------------------------------------------------------


def _f32(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


class _Writer:
    """Reads the policy's `lm.*` tensors as f32 numpy and writes HF names."""

    def __init__(self, sd: Dict[str, torch.Tensor]):
        self.sd, self.out = sd, {}

    def get(self, name: str) -> np.ndarray:
        return _f32(self.sd["lm." + name])

    def copy(self, theirs: str, ours: str, bias: bool = True) -> None:
        """A norm, or a Linear (HF's has the port's [out, in] layout)."""
        self.out[theirs + ".weight"] = self.get(ours + ".weight")
        if bias:
            self.out[theirs + ".bias"] = self.get(ours + ".bias")


def _export_gpt2(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """GPT-2's Conv1D weights are [in, out]: the torch Linear weight
    transposed (the JAX kernel)."""
    w = _Writer(sd)
    w.out["transformer.wte.weight"] = w.get("embed_tokens.weight")
    w.out["transformer.wpe.weight"] = w.get("embed_pos.weight")
    w.copy("transformer.ln_f", "ln_f")
    for i in range(cfg.n_layers):
        b, p = f"block_{i}.", f"transformer.h.{i}."
        w.copy(p + "ln_1", b + "ln_attn")
        w.copy(p + "ln_2", b + "ln_mlp")
        w.out[p + "attn.c_attn.weight"] = np.concatenate(
            [w.get(b + f"attn.{n}.weight").T for n in ("q_proj", "k_proj", "v_proj")], axis=1)
        w.out[p + "attn.c_attn.bias"] = np.concatenate(
            [w.get(b + f"attn.{n}.bias") for n in ("q_proj", "k_proj", "v_proj")], axis=0)
        for theirs, ours in (("attn.c_proj", "attn.o_proj"), ("mlp.c_fc", "mlp.up_proj"),
                             ("mlp.c_proj", "mlp.down_proj")):
            w.out[p + theirs + ".weight"] = w.get(b + ours + ".weight").T
            w.out[p + theirs + ".bias"] = w.get(b + ours + ".bias")
    w.out["lm_head.weight"] = w.out["transformer.wte.weight"]
    return w.out


def _export_llama(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    w = _Writer(sd)
    w.out["model.embed_tokens.weight"] = w.get("embed_tokens.weight")
    w.out["model.norm.weight"] = w.get("ln_f.weight")
    for i in range(cfg.n_layers):
        b, p = f"block_{i}.", f"model.layers.{i}."
        w.out[p + "input_layernorm.weight"] = w.get(b + "ln_attn.weight")
        w.out[p + "post_attention_layernorm.weight"] = w.get(b + "ln_mlp.weight")
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            w.out[p + f"self_attn.{n}.weight"] = w.get(b + f"attn.{n}.weight")
        for n in ("gate_proj", "up_proj", "down_proj"):
            w.out[p + f"mlp.{n}.weight"] = w.get(b + f"mlp.{n}.weight")
    if "lm.lm_head.weight" in sd:
        w.out["lm_head.weight"] = w.get("lm_head.weight")
    else:
        w.out["lm_head.weight"] = w.out["model.embed_tokens.weight"]
    return w.out


def _fused_qkv(w: _Writer, b: str, cfg: TransformerConfig, leaf: str) -> np.ndarray:
    return _fuse_qkv_per_head(*(w.get(b + f"attn.{n}.{leaf}") for n in ("q_proj", "k_proj", "v_proj")),
                              cfg.n_heads, cfg.head_dim)


def _export_gpt_neox(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    w = _Writer(sd)
    w.out["gpt_neox.embed_in.weight"] = w.get("embed_tokens.weight")
    w.copy("gpt_neox.final_layer_norm", "ln_f")
    w.out["embed_out.weight"] = w.get("lm_head.weight")
    for i in range(cfg.n_layers):
        b, p = f"block_{i}.", f"gpt_neox.layers.{i}."
        w.copy(p + "input_layernorm", b + "ln_attn")
        w.copy(p + "post_attention_layernorm", b + "ln_mlp")
        w.out[p + "attention.query_key_value.weight"] = _fused_qkv(w, b, cfg, "weight")
        w.out[p + "attention.query_key_value.bias"] = _fused_qkv(w, b, cfg, "bias")
        w.copy(p + "attention.dense", b + "attn.o_proj")
        w.copy(p + "mlp.dense_h_to_4h", b + "mlp.up_proj")
        w.copy(p + "mlp.dense_4h_to_h", b + "mlp.down_proj")
    return w.out


def _export_gptj(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    w = _Writer(sd)
    w.out["transformer.wte.weight"] = w.get("embed_tokens.weight")
    w.copy("transformer.ln_f", "ln_f")
    w.copy("lm_head", "lm_head")
    for i in range(cfg.n_layers):
        b, p = f"block_{i}.", f"transformer.h.{i}."
        w.copy(p + "ln_1", b + "ln_attn")
        for n, heads in (("q_proj", cfg.n_heads), ("k_proj", cfg.kv_heads)):
            w.out[p + f"attn.{n}.weight"] = _permute_rotary_cols(
                torch.from_numpy(w.get(b + f"attn.{n}.weight")), cfg, heads, inverse=True).numpy()
        w.copy(p + "attn.v_proj", b + "attn.v_proj", bias=False)
        w.copy(p + "attn.out_proj", b + "attn.o_proj", bias=False)
        w.copy(p + "mlp.fc_in", b + "mlp.up_proj")
        w.copy(p + "mlp.fc_out", b + "mlp.down_proj")
    return w.out


def _export_opt(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    w = _Writer(sd)
    w.out["model.decoder.embed_tokens.weight"] = w.get("embed_tokens.weight")
    w.out["model.decoder.embed_positions.weight"] = w.get("embed_pos.weight")
    w.copy("model.decoder.final_layer_norm", "ln_f")
    for i in range(cfg.n_layers):
        b, p = f"block_{i}.", f"model.decoder.layers.{i}."
        w.copy(p + "self_attn_layer_norm", b + "ln_attn")
        w.copy(p + "final_layer_norm", b + "ln_mlp")
        for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                             ("o_proj", "out_proj")):
            w.copy(p + f"self_attn.{theirs}", b + f"attn.{ours}")
        w.copy(p + "fc1", b + "mlp.up_proj")
        w.copy(p + "fc2", b + "mlp.down_proj")
    w.out["lm_head.weight"] = w.out["model.decoder.embed_tokens.weight"]
    return w.out


def _export_bloom(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    w = _Writer(sd)
    w.out["transformer.word_embeddings.weight"] = w.get("embed_tokens.weight")
    w.copy("transformer.word_embeddings_layernorm", "ln_embed")
    w.copy("transformer.ln_f", "ln_f")
    for i in range(cfg.n_layers):
        b, p = f"block_{i}.", f"transformer.h.{i}."
        w.copy(p + "input_layernorm", b + "ln_attn")
        w.copy(p + "post_attention_layernorm", b + "ln_mlp")
        w.out[p + "self_attention.query_key_value.weight"] = _fused_qkv(w, b, cfg, "weight")
        w.out[p + "self_attention.query_key_value.bias"] = _fused_qkv(w, b, cfg, "bias")
        w.copy(p + "self_attention.dense", b + "attn.o_proj")
        w.copy(p + "mlp.dense_h_to_4h", b + "mlp.up_proj")
        w.copy(p + "mlp.dense_4h_to_h", b + "mlp.down_proj")
    w.out["lm_head.weight"] = w.out["transformer.word_embeddings.weight"]
    return w.out


def _export_gpt_bigcode(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    w = _Writer(sd)
    w.out["transformer.wte.weight"] = w.get("embed_tokens.weight")
    w.out["transformer.wpe.weight"] = w.get("embed_pos.weight")
    w.copy("transformer.ln_f", "ln_f")
    for i in range(cfg.n_layers):
        b, p = f"block_{i}.", f"transformer.h.{i}."
        w.copy(p + "ln_1", b + "ln_attn")
        w.copy(p + "ln_2", b + "ln_mlp")
        w.out[p + "attn.c_attn.weight"] = np.concatenate(
            [w.get(b + f"attn.{n}.weight") for n in ("q_proj", "k_proj", "v_proj")], axis=0)
        w.out[p + "attn.c_attn.bias"] = np.concatenate(
            [w.get(b + f"attn.{n}.bias") for n in ("q_proj", "k_proj", "v_proj")], axis=0)
        w.copy(p + "attn.c_proj", b + "attn.o_proj")
        w.copy(p + "mlp.c_fc", b + "mlp.up_proj")
        w.copy(p + "mlp.c_proj", b + "mlp.down_proj")
    w.out["lm_head.weight"] = w.out["transformer.wte.weight"]
    return w.out


def _export_t5(sd: Dict[str, torch.Tensor], cfg: Seq2SeqConfig) -> Dict[str, np.ndarray]:
    """The inverse of `_load_t5`, with the per-stack embedding copies HF
    checkpoints carry and the head (the shared embedding when tied)."""
    w = _Writer(sd)
    for ours, theirs in _t5_names(cfg):
        w.out[theirs] = w.get(ours)
    w.out["encoder.embed_tokens.weight"] = w.out["decoder.embed_tokens.weight"] = w.out["shared.weight"]
    w.out["lm_head.weight"] = w.out["shared.weight"] if cfg.tie_embeddings else w.get("lm_head.weight")
    return w.out


_EXPORTERS = {
    "t5": _export_t5,
    "gpt2": _export_gpt2,
    "llama": _export_llama,
    "gpt_neox": _export_gpt_neox,
    "gptj": _export_gptj,
    "opt": _export_opt,
    "bloom": _export_bloom,
    "gpt_bigcode": _export_gpt_bigcode,
}


def infer_family(cfg: TransformerConfig) -> str:
    """The HF family of a model config that was not loaded from an HF
    directory, from its structure (the JAX package's rules)."""
    if getattr(cfg, "is_seq2seq", False):
        return "t5"
    if cfg.alibi:
        return "bloom"
    if cfg.pos_offset:
        return "opt"
    if cfg.parallel_residual:
        return "gptj" if cfg.shared_ln else "gpt_neox"
    if cfg.pos_embed == "rope":
        return "llama"
    if cfg.kv_heads != cfg.n_heads:
        return "gpt_bigcode"
    return "gpt2"


def params_to_hf_state_dict(state_dict: Dict[str, torch.Tensor], cfg: TransformerConfig,
                            family: str = None) -> Dict[str, np.ndarray]:
    """The policy's state dict -> an HF-layout state dict of f32 arrays."""
    _check_dense(cfg, "HF export")
    family = family or cfg.hf_family or infer_family(cfg)
    return _EXPORTERS[family](state_dict, cfg)


def config_to_hf(cfg: TransformerConfig, family: str = None) -> Dict:
    """Inverse of `config_from_hf`: a loadable HF config dict (model_type
    and architectures included), also for models born from presets."""
    _check_dense(cfg, "HF config export")
    family = family or cfg.hf_family or infer_family(cfg)
    if family == "t5":
        # the inverse of the import's activation mapping: HF runs
        # ACT2FN[dense_act_fn], 'gelu' exact and 'gelu_new' the tanh form;
        # 'gated-gelu' forces gelu_new on import, our "gelu"
        if cfg.glu:
            if cfg.activation == "gelu_exact":
                raise ValueError("T5 cannot express a gated exact-erf GELU (gated-gelu always runs gelu_new)")
            ffp = {"gelu": "gated-gelu", "silu": "gated-silu", "relu": "gated-relu"}[cfg.activation]
        else:
            ffp = {"relu": "relu", "gelu_exact": "gelu", "silu": "silu", "gelu": "gelu_new"}[cfg.activation]
        return dict(
            model_type="t5", architectures=["T5ForConditionalGeneration"], is_encoder_decoder=True,
            vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.head_dim, d_ff=cfg.d_ff,
            num_layers=cfg.n_encoder_layers, num_decoder_layers=cfg.n_decoder_layers, num_heads=cfg.n_heads,
            relative_attention_num_buckets=cfg.relative_attention_num_buckets,
            relative_attention_max_distance=cfg.relative_attention_max_distance,
            feed_forward_proj=ffp, tie_word_embeddings=cfg.tie_embeddings,
            layer_norm_epsilon=cfg.layer_norm_epsilon, decoder_start_token_id=cfg.decoder_start_token_id,
            # the source tokenizer's ids (recorded at import); a preset's
            # fall back to T5's conventions
            pad_token_id=cfg.pad_token_id if cfg.pad_token_id is not None else cfg.decoder_start_token_id,
            eos_token_id=cfg.eos_token_id if cfg.eos_token_id is not None else 1,
        )
    if family == "gpt2":
        return dict(
            model_type="gpt2", architectures=["GPT2LMHeadModel"],
            vocab_size=cfg.vocab_size, n_embd=cfg.d_model, n_layer=cfg.n_layers,
            n_head=cfg.n_heads, n_inner=cfg.d_ff, n_positions=cfg.max_seq_len,
            n_ctx=cfg.max_seq_len, layer_norm_epsilon=cfg.layer_norm_epsilon,
            activation_function="gelu_new",
            tie_word_embeddings=cfg.tie_embeddings,
        )
    if family == "llama":
        mistral = cfg.sliding_window is not None
        return dict(
            model_type="mistral" if mistral else "llama",
            architectures=["MistralForCausalLM" if mistral else "LlamaForCausalLM"],
            vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
            num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
            num_key_value_heads=cfg.kv_heads, intermediate_size=cfg.d_ff,
            max_position_embeddings=cfg.max_seq_len, rope_theta=cfg.rope_theta,
            rms_norm_eps=cfg.layer_norm_epsilon,
            tie_word_embeddings=cfg.tie_embeddings, hidden_act="silu",
            **({"sliding_window": cfg.sliding_window} if mistral else {}),
        )
    if family == "gpt_neox":
        return dict(
            model_type="gpt_neox", architectures=["GPTNeoXForCausalLM"],
            vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
            num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
            intermediate_size=cfg.d_ff, max_position_embeddings=cfg.max_seq_len,
            rotary_pct=cfg.rotary_pct, rotary_emb_base=cfg.rope_theta,
            use_parallel_residual=cfg.parallel_residual,
            tie_word_embeddings=cfg.tie_embeddings,
            layer_norm_eps=cfg.layer_norm_epsilon,
            # import maps hidden_act == "gelu" to gelu_exact, else tanh-gelu
            hidden_act="gelu" if cfg.activation == "gelu_exact" else "gelu_new",
        )
    if family == "gptj":
        return dict(
            model_type="gptj", architectures=["GPTJForCausalLM"],
            vocab_size=cfg.vocab_size, n_embd=cfg.d_model, n_layer=cfg.n_layers,
            n_head=cfg.n_heads, n_inner=cfg.d_ff, n_positions=cfg.max_seq_len,
            rotary_dim=cfg.rotary_dim, layer_norm_epsilon=cfg.layer_norm_epsilon,
            activation_function="gelu_new",
        )
    if family == "opt":
        return dict(
            model_type="opt", architectures=["OPTForCausalLM"],
            vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
            num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
            ffn_dim=cfg.d_ff, max_position_embeddings=cfg.max_seq_len,
            do_layer_norm_before=True, word_embed_proj_dim=cfg.d_model,
            activation_function="relu" if cfg.activation == "relu" else "gelu",
        )
    if family == "bloom":
        if cfg.d_ff != 4 * cfg.d_model:
            # the HF bloom config has no d_ff field (import assumes 4x)
            raise ValueError(f"bloom export requires d_ff == 4*d_model, got {cfg.d_ff}")
        return dict(
            model_type="bloom", architectures=["BloomForCausalLM"],
            vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
            n_layer=cfg.n_layers, n_head=cfg.n_heads,
            layer_norm_epsilon=cfg.layer_norm_epsilon,
        )
    if family == "gpt_bigcode":
        if cfg.kv_heads not in (1, cfg.n_heads):
            raise ValueError("gpt_bigcode export supports multi_query (1 kv head) or "
                             f"full MHA only, got n_kv_heads={cfg.kv_heads}")
        return dict(
            model_type="gpt_bigcode", architectures=["GPTBigCodeForCausalLM"],
            vocab_size=cfg.vocab_size, n_embd=cfg.d_model, n_layer=cfg.n_layers,
            n_head=cfg.n_heads, n_inner=cfg.d_ff, n_positions=cfg.max_seq_len,
            multi_query=cfg.kv_heads == 1,
            layer_norm_epsilon=cfg.layer_norm_epsilon,
        )
    raise ValueError(f"No HF config export for family '{family}'")
