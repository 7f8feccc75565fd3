"""HF checkpoint interop for the gpt2 and llama families (port of the JAX
package's `models/hf_interop.py`): build a TransformerConfig from a local
directory's `config.json`, load its weights (`pytorch_model.bin`, its
sharded index, or safetensors where the `safetensors` package imports)
into the policy's state dict, and export the policy back to that layout
(`save_pretrained`). The other families are ROADMAP queue A, item 4.
Nothing is downloaded: a model path is a local directory.

The port's parameters carry the JAX tree's names with torch layouts
(`lm.block_0.attn.q_proj.weight` is the JAX kernel transposed), so load
and export read and write the module's state dict directly.
"""

import json
import os
from typing import Dict

import numpy as np
import torch

from trlx_tpu_torch.models.transformer import TransformerConfig

_PORTED_FAMILIES = ("gpt2", "llama")
_OTHER_FAMILIES = "(ROADMAP queue A, item 4: the other HF families)"


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


def _check_ported(fam: str, path: str) -> None:
    if fam not in _PORTED_FAMILIES:
        raise NotImplementedError(f"loading the {fam!r} family from '{path}' is not ported yet; gpt2 and llama "
                                  f"are {_OTHER_FAMILIES}")


def config_from_hf(path: str, **overrides) -> TransformerConfig:
    """A TransformerConfig from the directory's `config.json` (gpt2 and
    llama; `overrides` win, as `model_extra_configs` do for presets)."""
    hf = _read_hf_config(path)
    fam = _family_of(hf)
    _check_ported(fam, path)
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
    else:
        kwargs = dict(
            vocab_size=hf["vocab_size"], d_model=hf["hidden_size"],
            n_layers=hf["num_hidden_layers"], n_heads=hf["num_attention_heads"],
            n_kv_heads=hf.get("num_key_value_heads"), d_ff=hf["intermediate_size"],
            max_seq_len=hf.get("max_position_embeddings", 4096), pos_embed="rope",
            norm="rmsnorm", activation="silu", glu=True,
            tie_embeddings=bool(hf.get("tie_word_embeddings", False)), use_bias=False,
            rope_theta=hf.get("rope_theta", 10000.0),
            layer_norm_epsilon=hf.get("rms_norm_eps", 1e-6),
            sliding_window=hf.get("sliding_window"),
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
    """Drop a leading wrapper prefix (`transformer.`) if any key carries it."""
    for p in prefixes:
        if any(k.startswith(p) for k in sd):
            return {k[len(p):] if k.startswith(p) else k: v for k, v in sd.items()}
    return sd


def _load_gpt2(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """GPT-2's Conv1D weights are [in, out]: the port's Linear weight is
    their transpose; the fused c_attn splits into q, k, v."""
    sd = _strip_prefix(sd, "transformer.")
    lm = {
        "embed_tokens.weight": sd["wte.weight"],
        "embed_pos.weight": sd["wpe.weight"],
        "ln_f.weight": sd["ln_f.weight"],
        "ln_f.bias": sd["ln_f.bias"],
    }
    for i in range(cfg.n_layers):
        p, b = f"h.{i}.", f"block_{i}."
        for ours, theirs in (("ln_attn", "ln_1"), ("ln_mlp", "ln_2")):
            lm[b + ours + ".weight"] = sd[p + theirs + ".weight"]
            lm[b + ours + ".bias"] = sd[p + theirs + ".bias"]
        qkv_w = torch.chunk(sd[p + "attn.c_attn.weight"], 3, dim=1)
        qkv_b = torch.chunk(sd[p + "attn.c_attn.bias"], 3, dim=0)
        for n, w, bias in zip(("q_proj", "k_proj", "v_proj"), qkv_w, qkv_b):
            lm[b + f"attn.{n}.weight"] = w.t()
            lm[b + f"attn.{n}.bias"] = bias
        for ours, theirs in (("attn.o_proj", "attn.c_proj"), ("mlp.up_proj", "mlp.c_fc"),
                             ("mlp.down_proj", "mlp.c_proj")):
            lm[b + ours + ".weight"] = sd[p + theirs + ".weight"].t()
            lm[b + ours + ".bias"] = sd[p + theirs + ".bias"]
    return lm


def _load_llama(sd: Dict[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """Llama's Linear weights are [out, in], as the port's are."""
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


_LOADERS = {"gpt2": _load_gpt2, "llama": _load_llama}


def load_params_from_hf(path: str, cfg: TransformerConfig,
                        state_template: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The template state dict with every `lm.*` entry replaced by the
    directory's weights, in the template's dtype and device (a shape that
    differs raises). Entries outside the LM (the value head) keep the
    template's fresh init, as in the JAX package."""
    hf = _read_hf_config(path)
    fam = _family_of(hf)
    _check_ported(fam, path)
    lm = _LOADERS[fam](_load_state_dict(path), cfg)
    out = dict(state_template)
    for name, tpl in state_template.items():
        if not name.startswith("lm."):
            continue
        if name[3:] not in lm:
            raise KeyError(f"{name} has no counterpart in the {fam} checkpoint at {path}")
        w = lm[name[3:]]
        if tuple(w.shape) != tuple(tpl.shape):
            raise ValueError(f"Converted weight {name} has shape {tuple(w.shape)} != expected {tuple(tpl.shape)}")
        out[name] = w.to(dtype=tpl.dtype, device=tpl.device).contiguous()
    return out


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
