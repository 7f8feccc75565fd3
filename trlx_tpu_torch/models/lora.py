"""Adapters: LoRA, prompt tuning and prefix tuning (the reference's peft
integration), the port's own copy of the JAX package's `models/lora.py`.

The adapters are parameters of the modules they adapt
(`models/transformer.py`):
- LoRA: a `Linear` named in `cfg.lora_targets` owns `lora_a` [in, r] and
  `lora_b` [r, out] (the JAX leaves `<name>_lora_a` / `<name>_lora_b`,
  same orientation) and adds ((x A) B) alpha / r to its output;
- prompt tuning: the LM's `soft_prompt` [P, d], prepended to every
  sequence;
- prefix tuning: each attention's `prefix_k` / `prefix_v` [P, nkv, hd],
  keys and values every query sees.

With adapters on, every base weight is frozen (`policy.trainable_mask`)
and the reference of PPO's KL penalty is the live LM run with its
adapters off (`policy.AdapterReference`): the forwards take `adapters=
False` and skip the LoRA delta, the soft prompt and the prefixes. A
skipped delta equals the JAX package's zeroed one bitwise (its delta on
zero factors is exactly 0.0), and no second copy of the base is made.
For the export `merge_lora_into_state_dict` folds A B alpha / r into the
base weights (peft's merge_and_unload).
"""

from typing import Any, Dict

import torch

LORA_SUFFIXES = (".lora_a", ".lora_b")
PROMPT_NAME = "soft_prompt"
PREFIX_NAMES = ("prefix_k", "prefix_v")


def lora_overrides_from_peft_config(peft_config: Any) -> Dict[str, Any]:
    """A reference-style peft config (a dict or a peft config object) ->
    TransformerConfig overrides: LORA (`r`, `lora_alpha`,
    `target_modules`), PROMPT_TUNING and PREFIX_TUNING
    (`num_virtual_tokens`)."""
    if peft_config is None:
        return {}
    if not isinstance(peft_config, dict):
        peft_config = {
            k: getattr(peft_config, k)
            for k in ("peft_type", "r", "lora_alpha", "target_modules", "num_virtual_tokens")
            if hasattr(peft_config, k)
        }
    peft_type = peft_config.get("peft_type", "LORA")
    # peft's PeftType is a str enum whose str() is "PeftType.LORA": compare its value
    peft_type = str(getattr(peft_type, "value", peft_type)).upper()
    if peft_type == "PROMPT_TUNING":
        return {"prompt_tokens": int(peft_config.get("num_virtual_tokens", 8))}
    if peft_type == "PREFIX_TUNING":
        # attn_impl is not set here: "xla" is the default, and
        # TransformerConfig refuses the fused paths under prefixes
        return {"prefix_tokens": int(peft_config.get("num_virtual_tokens", 8))}
    if peft_type != "LORA":
        raise ValueError(f"Unsupported peft_type '{peft_type}' (LORA, PROMPT_TUNING, PREFIX_TUNING)")
    overrides: Dict[str, Any] = {"lora_rank": int(peft_config.get("r", 8))}
    if "lora_alpha" in peft_config:
        overrides["lora_alpha"] = float(peft_config["lora_alpha"])
    if peft_config.get("target_modules"):
        overrides["lora_targets"] = tuple(peft_config["target_modules"])
    return overrides


def has_adapters(cfg) -> bool:
    return cfg.lora_rank > 0 or cfg.prompt_tokens > 0 or cfg.prefix_tokens > 0


def is_lora_name(name: str) -> bool:
    """A LoRA factor's state-dict name (`...q_proj.lora_a`)."""
    return name.endswith(LORA_SUFFIXES)


def is_adapter_name(name: str) -> bool:
    """Any adapter's state-dict name: a LoRA factor, the soft prompt or a
    prefix."""
    last = name.rsplit(".", 1)[-1]
    return is_lora_name(name) or last == PROMPT_NAME or last in PREFIX_NAMES


def merge_lora_into_state_dict(state: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """Every LoRA pair folded into its base weight, W' = W + (A B)^T alpha
    / r in f32 (the Linear's weight is [out, in], the JAX kernel
    transposed), cast back to W's dtype; the factors dropped. The other
    entries pass through."""
    scale = cfg.lora_alpha / max(cfg.lora_rank, 1)
    out = {k: v for k, v in state.items() if not is_lora_name(k)}
    for name, a in state.items():
        if not name.endswith(".lora_a"):
            continue
        base = name[: -len(".lora_a")]
        b = state[base + ".lora_b"]
        w = out[base + ".weight"]
        delta = (a.float() @ b.float()) * scale  # [in, out]
        out[base + ".weight"] = (w.float() + delta.T).to(w.dtype)
    return out
