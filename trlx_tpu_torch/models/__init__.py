"""Model construction from a ModelConfig: causal value-head policies from
`random:` presets (loading an HF checkpoint directory is ROADMAP queue A,
item 4)."""

from typing import Optional, Tuple

import torch

from trlx_tpu_torch.models.heads import MLPHead  # noqa: F401
from trlx_tpu_torch.models.policy import (  # noqa: F401
    CausalLMWithValueHead,
    HydraReference,
    forward_policy_and_ref,
    resolve_split,
    trainable_mask,
)
from trlx_tpu_torch.models.transformer import (  # noqa: F401
    PRESETS,
    TransformerConfig,
    TransformerLM,
    config_from_preset,
    init_kv_cache,
    init_paged_kv_arena,
    position_ids,
)

DTYPES = {
    "float32": torch.float32,
    "f32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def resolve_transformer_config(model_config, vocab_size: int) -> TransformerConfig:
    """Build a TransformerConfig from a ModelConfig. `model_extra_configs`
    may override preset fields, `dtype` (the activation dtype, as a
    string) and `vocab_size` (e.g. the real 50257-token softmax with a byte
    tokenizer)."""
    path = model_config.model_path
    extra = dict(model_config.model_extra_configs or {})
    if getattr(model_config, "model_arch_type", "causal") != "causal":
        raise NotImplementedError("seq2seq models are not ported yet (ROADMAP queue A, item 4: model features)")
    if getattr(model_config, "peft_config", None) is not None:
        raise NotImplementedError("peft/LoRA is not ported yet (ROADMAP queue A, item 4: model features)")
    if "dtype" in extra:
        name = str(extra.pop("dtype"))
        if name not in DTYPES:
            raise ValueError(f"dtype {name!r} not in {sorted(DTYPES)}")
        extra["dtype"] = DTYPES[name]
    if not path.startswith("random:"):
        raise NotImplementedError(
            f"loading '{path}' from an HF checkpoint is not ported yet; use a "
            "random:<preset> model (ROADMAP queue A, item 4: HF loading)"
        )
    vocab_size = extra.pop("vocab_size", vocab_size)
    return config_from_preset(path[len("random:"):], vocab_size=vocab_size, **extra)


def build_model(model_config, vocab_size: int, seed: int = 0,
                device="cuda") -> Tuple[CausalLMWithValueHead, TransformerConfig, dict]:
    """Returns (module, model config, state dict) for a causal value-head
    policy with random weights drawn from `seed` on `device`."""
    cfg = resolve_transformer_config(model_config, vocab_size)
    device = torch.device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    model = CausalLMWithValueHead(cfg, device=device, generator=generator)
    model.eval()
    return model, cfg, model.state_dict()
