"""Model construction from a ModelConfig: causal value-head policies (with
the deeper value branch under `num_value_layers`), the critic-free policy
of GRPO/RLOO (`value_head=False`) and ILQL policies, from `random:`
presets or from a local HF checkpoint directory (gpt2, llama/mistral,
gpt_neox, gptj, opt, bloom, gpt_bigcode and t5, `models/hf_interop.py`),
with the adapters of a `peft_config` (LoRA, prompt tuning, prefix tuning,
`models/lora.py`). `model_arch_type="seq2seq"` builds the encoder-decoder
family (`models/seq2seq.py`): its presets are `SEQ2SEQ_PRESETS`, and a
checkpoint's family must agree with the arch type, as in the JAX package;
`trainable_mask` and `make_reference` dispatch on the config."""

from typing import Dict, Tuple, Union

import torch

from trlx_tpu_torch.models.heads import ILQLHeads, MLPHead, sync_target_q_heads  # noqa: F401
from trlx_tpu_torch.models.lora import lora_overrides_from_peft_config
from trlx_tpu_torch.models import policy
from trlx_tpu_torch.models.policy import (  # noqa: F401
    AdapterReference,
    CausalLMPolicy,
    CausalLMWithILQLHeads,
    CausalLMWithValueHead,
    HydraReference,
    ValueBranch,
    forward_policy_and_ref,
    resolve_split,
    target_q_mask,
)
from trlx_tpu_torch.models.seq2seq import (  # noqa: F401
    SEQ2SEQ_PRESETS,
    Seq2SeqConfig,
    Seq2SeqHydraReference,
    Seq2SeqLM,
    Seq2SeqLMWithILQLHeads,
    Seq2SeqLMWithValueHead,
    forward_seq2seq_policy_and_ref,
    seq2seq_config_from_preset,
    seq2seq_trainable_mask,
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


def is_seq2seq_config(cfg) -> bool:
    return bool(getattr(cfg, "is_seq2seq", False))


def trainable_mask(model, cfg, num_layers_unfrozen: int) -> Dict[str, bool]:
    """The family's trainable mask: `seq2seq_trainable_mask` for an
    encoder-decoder, else `policy.trainable_mask`."""
    if is_seq2seq_config(cfg):
        return seq2seq_trainable_mask(model, cfg, num_layers_unfrozen)
    return policy.trainable_mask(model, cfg, num_layers_unfrozen)


def make_reference(lm, split: int):
    """PPO's frozen reference for the LM's family: the decoder's hydra copy
    for an encoder-decoder, else `policy.make_reference`."""
    if is_seq2seq_config(lm.cfg):
        return Seq2SeqHydraReference(lm, split)
    return policy.make_reference(lm, split)


def resolve_transformer_config(model_config, vocab_size: int) -> Union[TransformerConfig, Seq2SeqConfig]:
    """Build a TransformerConfig (or, under `model_arch_type="seq2seq"`, a
    Seq2SeqConfig) from a ModelConfig: a `random:<preset>` or a local HF
    checkpoint directory (its `config.json`). `model_extra_configs` may
    override config fields and `dtype` (the activation dtype, as a
    string); for a preset also `vocab_size` (e.g. the real 50257-token
    softmax with a byte tokenizer), which a checkpoint takes as a plain
    override. A `peft_config` adds its adapters' overrides (causal models
    only). The arch type is the one source the trainers dispatch on: a
    seq2seq preset or checkpoint under "causal", or the reverse, raises."""
    path = model_config.model_path
    extra = dict(model_config.model_extra_configs or {})
    seq2seq = getattr(model_config, "model_arch_type", "causal") == "seq2seq"
    if "dtype" in extra:
        name = str(extra.pop("dtype"))
        if name not in DTYPES:
            raise ValueError(f"dtype {name!r} not in {sorted(DTYPES)}")
        extra["dtype"] = DTYPES[name]
    peft_config = getattr(model_config, "peft_config", None)
    if peft_config is not None and seq2seq:
        raise NotImplementedError("LoRA is only supported for causal models")
    extra.update(lora_overrides_from_peft_config(peft_config))
    if not path.startswith("random:"):
        from trlx_tpu_torch.models import hf_interop

        cfg = hf_interop.config_from_hf(path, **extra)
        if is_seq2seq_config(cfg) != seq2seq:
            want = "seq2seq" if is_seq2seq_config(cfg) else "causal"
            raise ValueError(
                f"Checkpoint at '{path}' is a {want} model but "
                f"model_arch_type={'seq2seq' if seq2seq else 'causal'!r}; set "
                f"model_arch_type='{want}' in ModelConfig"
            )
        return cfg
    preset = path[len("random:"):]
    vocab_size = extra.pop("vocab_size", vocab_size)
    if preset in SEQ2SEQ_PRESETS and not seq2seq:
        raise ValueError(f"Preset '{preset}' is an encoder-decoder model; set model_arch_type='seq2seq' in "
                         "ModelConfig to use it")
    if seq2seq:
        return seq2seq_config_from_preset(preset, vocab_size=vocab_size, **extra)
    return config_from_preset(preset, vocab_size=vocab_size, **extra)


def build_model(model_config, vocab_size: int, seed: int = 0, device="cuda", with_ilql_heads: bool = False,
                two_qs: bool = True, num_value_layers: int = 0, value_head: bool = True,
                ) -> Tuple[Union[CausalLMWithValueHead, CausalLMWithILQLHeads], TransformerConfig, dict]:
    """Returns (module, model config, state dict) on `device`, its weights
    drawn from `seed` and, when `model_path` is a local HF directory, its
    LM's weights loaded from there (the heads keep their fresh init): a
    causal value-head policy, its value head the deeper branch when
    `num_value_layers > 0` (clones of the top blocks and the final norm,
    taken after init and load; its MLP head keeps its own init); with
    `value_head=False` the critic-free `CausalLMPolicy` (GRPO/RLOO); or
    with `with_ilql_heads` an LM with ILQL's heads. A seq2seq config
    builds `Seq2SeqLMWithValueHead` or `Seq2SeqLMWithILQLHeads`."""
    cfg = resolve_transformer_config(model_config, vocab_size)
    if num_value_layers > 0 and (cfg.prompt_tokens > 0 or cfg.prefix_tokens > 0):
        raise NotImplementedError("num_value_layers_unfrozen with prompt/prefix tuning is not supported (the "
                                  "reference likewise leaves peft off the value branch)")
    if not value_head:
        if is_seq2seq_config(cfg):
            raise NotImplementedError("critic-free (value_head=False) models are causal-only")
        if with_ilql_heads:
            raise ValueError("value_head=False conflicts with with_ilql_heads (ILQL needs its heads)")
        if num_value_layers > 0:
            raise ValueError("value_head=False conflicts with num_value_layers > 0: a critic-free policy has no "
                             "value branch to deepen")
    if num_value_layers > 0 and with_ilql_heads:
        raise NotImplementedError("the value branch is a PPO-value-head feature")
    device = torch.device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    if is_seq2seq_config(cfg):
        if num_value_layers > 0:
            raise NotImplementedError("num_value_layers_unfrozen > 0 is causal-only (as in the reference, whose "
                                      "make_value_branch targets causal branches)")
        if with_ilql_heads:
            model = Seq2SeqLMWithILQLHeads(cfg, device=device, generator=generator, two_qs=two_qs)
        else:
            model = Seq2SeqLMWithValueHead(cfg, device=device, generator=generator)
    elif with_ilql_heads:
        model = CausalLMWithILQLHeads(cfg, device=device, generator=generator, two_qs=two_qs)
    elif not value_head:
        model = CausalLMPolicy(cfg, device=device, generator=generator)
    else:
        model = CausalLMWithValueHead(cfg, device=device, generator=generator, num_value_layers=num_value_layers)
    if cfg.lora_rank > 0 and not any(name.endswith(".lora_a") for name, _ in model.named_parameters()):
        # e.g. HF-native names ('c_attn', 'query_key_value'): training the
        # heads alone would pass silently
        raise ValueError(f"peft_config target modules {cfg.lora_targets} matched no projection; valid targets: "
                         "q_proj, k_proj, v_proj, o_proj, up_proj, gate_proj, down_proj")
    if not model_config.model_path.startswith("random:"):
        from trlx_tpu_torch.models import hf_interop

        model.load_state_dict(hf_interop.load_params_from_hf(model_config.model_path, cfg, model.state_dict()))
    if num_value_layers > 0:
        model.value_branch.clone_from(model.lm)
    model.eval()
    return model, cfg, model.state_dict()
