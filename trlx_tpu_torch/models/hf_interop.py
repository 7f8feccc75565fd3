"""Export to the HF checkpoint layout (port of the export half of the JAX
package's `models/hf_interop.py`, for the gpt2 and llama families; the
other families and HF loading are ROADMAP queue A, item 4).

The port's parameters carry the JAX tree's names with torch layouts
(`lm.block_0.attn.q_proj.weight` is the JAX kernel transposed), so the
export reads the module's state dict directly.
"""

from typing import Dict

import numpy as np
import torch

from trlx_tpu_torch.models.transformer import TransformerConfig


def _f32(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _export_gpt2(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """GPT-2's Conv1D weights are [in, out]: the torch Linear weight
    transposed (the JAX kernel)."""
    out = {
        "transformer.wte.weight": _f32(sd["lm.embed_tokens.weight"]),
        "transformer.wpe.weight": _f32(sd["lm.embed_pos.weight"]),
        "transformer.ln_f.weight": _f32(sd["lm.ln_f.weight"]),
        "transformer.ln_f.bias": _f32(sd["lm.ln_f.bias"]),
    }
    for i in range(cfg.n_layers):
        b, p = f"lm.block_{i}.", f"transformer.h.{i}."
        out[p + "ln_1.weight"] = _f32(sd[b + "ln_attn.weight"])
        out[p + "ln_1.bias"] = _f32(sd[b + "ln_attn.bias"])
        out[p + "ln_2.weight"] = _f32(sd[b + "ln_mlp.weight"])
        out[p + "ln_2.bias"] = _f32(sd[b + "ln_mlp.bias"])
        out[p + "attn.c_attn.weight"] = np.concatenate(
            [_f32(sd[b + f"attn.{n}.weight"]).T for n in ("q_proj", "k_proj", "v_proj")], axis=1
        )
        out[p + "attn.c_attn.bias"] = np.concatenate(
            [_f32(sd[b + f"attn.{n}.bias"]) for n in ("q_proj", "k_proj", "v_proj")], axis=0
        )
        out[p + "attn.c_proj.weight"] = _f32(sd[b + "attn.o_proj.weight"]).T
        out[p + "attn.c_proj.bias"] = _f32(sd[b + "attn.o_proj.bias"])
        out[p + "mlp.c_fc.weight"] = _f32(sd[b + "mlp.up_proj.weight"]).T
        out[p + "mlp.c_fc.bias"] = _f32(sd[b + "mlp.up_proj.bias"])
        out[p + "mlp.c_proj.weight"] = _f32(sd[b + "mlp.down_proj.weight"]).T
        out[p + "mlp.c_proj.bias"] = _f32(sd[b + "mlp.down_proj.bias"])
    out["lm_head.weight"] = out["transformer.wte.weight"]
    return out


def _export_llama(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """Llama's Linear weights are [out, in], as the port's are."""
    out = {
        "model.embed_tokens.weight": _f32(sd["lm.embed_tokens.weight"]),
        "model.norm.weight": _f32(sd["lm.ln_f.weight"]),
    }
    for i in range(cfg.n_layers):
        b, p = f"lm.block_{i}.", f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = _f32(sd[b + "ln_attn.weight"])
        out[p + "post_attention_layernorm.weight"] = _f32(sd[b + "ln_mlp.weight"])
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[p + f"self_attn.{n}.weight"] = _f32(sd[b + f"attn.{n}.weight"])
        for n in ("gate_proj", "up_proj", "down_proj"):
            out[p + f"mlp.{n}.weight"] = _f32(sd[b + f"mlp.{n}.weight"])
    if "lm.lm_head.weight" in sd:
        out["lm_head.weight"] = _f32(sd["lm.lm_head.weight"])
    else:
        out["lm_head.weight"] = out["model.embed_tokens.weight"]
    return out


_EXPORTERS = {"gpt2": _export_gpt2, "llama": _export_llama}


def infer_family(cfg: TransformerConfig) -> str:
    """The HF family of a model config that was not loaded from an HF dir
    (the families the port runs: llama-style rope models and gpt2)."""
    if cfg.pos_embed == "rope":
        return "llama"
    if cfg.kv_heads != cfg.n_heads:
        return "gpt_bigcode"
    return "gpt2"


def params_to_hf_state_dict(state_dict: Dict[str, torch.Tensor], cfg: TransformerConfig,
                            family: str = None) -> Dict[str, np.ndarray]:
    """The policy's state dict -> an HF-layout state dict of f32 arrays."""
    family = family or cfg.hf_family or infer_family(cfg)
    if family not in _EXPORTERS:
        raise NotImplementedError(
            f"HF export of the {family!r} family is not ported yet (ROADMAP queue A, item 4)"
        )
    return _EXPORTERS[family](state_dict, cfg)


def config_to_hf(cfg: TransformerConfig, family: str = None) -> Dict:
    """A loadable HF config dict (model_type and architectures included)."""
    family = family or cfg.hf_family or infer_family(cfg)
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
        return dict(
            model_type="llama", architectures=["LlamaForCausalLM"],
            vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
            num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
            num_key_value_heads=cfg.kv_heads, intermediate_size=cfg.d_ff,
            max_position_embeddings=cfg.max_seq_len, rope_theta=cfg.rope_theta,
            rms_norm_eps=cfg.layer_norm_epsilon,
            tie_word_embeddings=cfg.tie_embeddings, hidden_act="silu",
        )
    raise NotImplementedError(f"HF config export of the {family!r} family is not ported yet (ROADMAP queue A, item 4)")
