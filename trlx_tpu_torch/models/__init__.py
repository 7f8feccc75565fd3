"""Model construction from a ModelConfig: causal value-head policies (with
the deeper value branch under `num_value_layers`) and ILQL policies from
`random:` presets (loading an HF checkpoint directory is ROADMAP queue A,
item 4)."""

from typing import Tuple, Union

import torch

from trlx_tpu_torch.models.heads import ILQLHeads, MLPHead, sync_target_q_heads  # noqa: F401
from trlx_tpu_torch.models.policy import (  # noqa: F401
    CausalLMWithILQLHeads,
    CausalLMWithValueHead,
    HydraReference,
    ValueBranch,
    forward_policy_and_ref,
    resolve_split,
    target_q_mask,
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


def build_model(model_config, vocab_size: int, seed: int = 0, device="cuda", with_ilql_heads: bool = False,
                two_qs: bool = True, num_value_layers: int = 0,
                ) -> Tuple[Union[CausalLMWithValueHead, CausalLMWithILQLHeads], TransformerConfig, dict]:
    """Returns (module, model config, state dict) with random weights drawn
    from `seed` on `device`: a causal value-head policy, its value head the
    deeper branch when `num_value_layers > 0` (clones of the top blocks and
    the final norm, taken after init; its MLP head keeps its own init), or
    with `with_ilql_heads` an LM with ILQL's heads."""
    cfg = resolve_transformer_config(model_config, vocab_size)
    if num_value_layers > 0 and with_ilql_heads:
        raise NotImplementedError("the value branch is a PPO-value-head feature")
    device = torch.device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    if with_ilql_heads:
        model = CausalLMWithILQLHeads(cfg, device=device, generator=generator, two_qs=two_qs)
    else:
        model = CausalLMWithValueHead(cfg, device=device, generator=generator, num_value_layers=num_value_layers)
        if num_value_layers > 0:
            model.value_branch.clone_from(model.lm)
    model.eval()
    return model, cfg, model.state_dict()
