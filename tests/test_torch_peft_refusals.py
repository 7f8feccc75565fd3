"""Adapter refusals, the learned-position guard and the HF load under an
adapter template against the JAX package, the cases of
`test_torch_peft.py` moved to a file of their own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so
these heavy ones fill a worker the parallelism files leave idle)."""

import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.inference.engine import InferenceEngine as JInferenceEngine
from trlx_tpu.models import CausalLMWithValueHead as JCausalLMWithValueHead
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.models import config_from_preset as j_config_from_preset
from trlx_tpu.models import forward_policy_and_ref as j_forward_policy_and_ref
from trlx_tpu.models import init_kv_cache as j_init_kv_cache
from trlx_tpu.models import ref_param_subtree as j_ref_param_subtree
from trlx_tpu.models import hf_interop as j_hf_interop
from trlx_tpu.models import lora as j_lora
from trlx_tpu.ops.sampling import GenerationConfig as JGenerationConfig
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLBatch
from trlx_tpu_torch.data.configs import ModelConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.inference import InferenceEngine
from trlx_tpu_torch.models import (
    AdapterReference,
    CausalLMWithValueHead,
    build_model,
    config_from_preset,
    init_kv_cache,
    init_paged_kv_arena,
)
from trlx_tpu_torch.models import hf_interop
from trlx_tpu_torch.models.lora import (
    is_adapter_name,
    is_lora_name,
    lora_overrides_from_peft_config,
    merge_lora_into_state_dict,
)
from trlx_tpu_torch.ops.sampling import GenerationConfig
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from test_torch_peft import (  # the cases' helpers, shared with test_torch_peft.py
    PEFT,
    V,
    _hf_dir,
    _models,
    _perturb,
    _ppo_config,
    _rows,
    _t,
    reward_fn,
)

torch.set_num_threads(1)


def test_refusals_match_jax():
    """Targets that name no projection, a value branch or a fused
    attention under prefixes, MoE under LoRA, the window and trunk passes
    under prompt tuning, and the slot-pool paths under virtual tokens."""
    for build, mc in ((j_build_model, JModelConfig), (build_model, ModelConfig)):
        kw = {} if build is j_build_model else dict(device="cpu")
        with pytest.raises(ValueError, match="matched no projection"):
            build(mc(model_path="random:gpt2-tiny",
                     peft_config={"peft_type": "LORA", "r": 2, "target_modules": ["c_attn"]}), V, **kw)
        with pytest.raises(NotImplementedError, match="num_value_layers_unfrozen with prompt/prefix tuning"):
            build(mc(model_path="random:gpt2-tiny", peft_config=PEFT["prompt"]), V, num_value_layers=1, **kw)
        with pytest.raises(NotImplementedError, match="prefix tuning needs the dense-bias attention path"):
            build(mc(model_path="random:gpt2-tiny", peft_config=PEFT["prefix"],
                     model_extra_configs={"attn_impl": "flash"}), V, **kw)
    for make in (j_config_from_preset, config_from_preset):
        with pytest.raises(NotImplementedError, match="LoRA adapters on MoE expert weights"):
            make("moe-tiny", vocab_size=V, lora_rank=4)
    _, _, _, tmodel, tcfg = _models("prompt", "gpt2-tiny")
    tokens, mask = _t(_rows()[0]), _t(_rows()[1])
    with pytest.raises(NotImplementedError, match="forward_window under prompt tuning"):
        tmodel.forward_window(tokens, mask, None, 2, 3)
    with pytest.raises(NotImplementedError, match="forward_trunk under prompt tuning"):
        tmodel.forward_trunk(tokens, mask, None, 1)
    with pytest.raises(NotImplementedError, match="split-activation capture under prompt tuning"):
        tmodel.decode_step(tokens, init_kv_cache(tcfg, 2, 16), mask, True, capture_split=1)
    for kind in ("prompt", "prefix"):
        _, _, _, tmodel, tcfg = _models(kind, "gpt2-tiny")
        with pytest.raises(NotImplementedError, match="paged KV cache under prompt/prefix tuning"):
            init_paged_kv_arena(tcfg, 4, 8)
        for call, what in ((tmodel.decode_step_rows, "slot-pool decode"), (tmodel.prefill_rows, "slot-pool prefill"),
                           (lambda *a: tmodel.spec_draft_step(*a, split=1), "speculative decode")):
            with pytest.raises(NotImplementedError, match=f"{what} under prompt/prefix tuning is unsupported"):
                call(tokens, {}, mask)


@pytest.mark.parametrize("kind", list(PEFT))
def test_hf_load_with_an_adapter_template_matches_jax(kind, tmp_path):
    """The base weights come from the directory, the adapters keep the
    template's fresh init (an HF base checkpoint has none): JAX's
    `load_params_from_hf` on its template and the port's on the same
    template give the same state; the adapters-off forward is the plain
    model's."""
    path, plain = _hf_dir(tmp_path, "gpt2-tiny")
    overrides = lora_overrides_from_peft_config(PEFT[kind])
    jcfg = j_hf_interop.config_from_hf(path, dtype=jnp.float32, **overrides)
    jtemplate = _perturb(jax.tree_util.tree_map(
        np.asarray, JCausalLMWithValueHead(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                                                      jnp.ones((1, 8), jnp.int32))["params"]))
    jloaded = j_hf_interop.load_params_from_hf(path, jcfg, jtemplate)
    tcfg = hf_interop.config_from_hf(path, dtype=torch.float32, **overrides)
    template = params_from_jax(jtemplate, tcfg)
    loaded = hf_interop.load_params_from_hf(path, tcfg, template)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jloaded), tcfg)
    assert loaded.keys() == want.keys()
    for name, w in want.items():
        assert torch.equal(loaded[name], w), name
        if is_adapter_name(name) or not name.startswith("lm."):
            assert torch.equal(loaded[name], template[name]), name
    model = CausalLMWithValueHead(tcfg).eval()
    model.load_state_dict(loaded)
    mc = ModelConfig(model_path=path, peft_config=PEFT[kind], model_extra_configs={"dtype": "float32"})
    built, bcfg, _ = build_model(mc, V, seed=0, device="cpu")
    assert (bcfg.lora_rank, bcfg.prompt_tokens, bcfg.prefix_tokens) == (tcfg.lora_rank, tcfg.prompt_tokens,
                                                                       tcfg.prefix_tokens)
    tokens, mask = _t(_rows(6)[0]), _t(_rows(6)[1])
    with torch.no_grad():
        base = plain(tokens, mask)[0]
        torch.testing.assert_close(model.lm(tokens, mask, adapters=False)[0], base, rtol=1e-6, atol=1e-6)
        assert torch.equal(built.lm(tokens, mask, adapters=False)[0], model.lm(tokens, mask, adapters=False)[0])


def test_learned_position_guard_matches_jax(tmp_path):
    """A soft prompt with learned positions: seq_length + P must fit the
    position table (gpt2-tiny's 256)."""
    from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
    from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer

    for make, cls, kw in ((j_default_ppo_config, JPPOTrainer, dict(devices=jax.devices()[:1])),
                          (default_ppo_config, PPOTrainer, dict(device="cpu"))):
        cfg = make().evolve(**{k: v for k, v in _ppo_config(tmp_path, "prompt", seq_length=256).to_dict().items()
                               if k in ("model", "tokenizer", "train", "method")})
        with pytest.raises(ValueError, match="learned-position table"):
            cls(cfg, reward_fn=reward_fn, **kw)
    PPOTrainer(_ppo_config(tmp_path, "prompt", seq_length=252), reward_fn=reward_fn, device="cpu")
