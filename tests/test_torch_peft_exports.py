"""`save_pretrained` under each adapter against the JAX package's export,
the cases of `test_torch_peft.py` moved to a file of their own (the
suite's `--dist loadfile` hands out the files with the fewest tests
last, so these heavy ones fill a worker the parallelism files leave
idle)."""

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
    _jax,
    _perturb,
    _ppo_config,
    _rows,
    _t,
    reward_fn,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", list(PEFT))
def test_save_pretrained_exports_match_jax(kind, tmp_path):
    """The export from the same weights: LoRA merged into the base
    (JAX's merge, 1e-6), and loaded back by `model_path` a plain model
    with the adapter model's logits (1e-5); the soft prompt and the
    prefixes beside the unmodified base, equal to JAX's files."""
    from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
    from trlx_tpu.trainer.base_trainer import partition_params
    from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer

    cfg = _ppo_config(tmp_path, kind)
    jt = JPPOTrainer(j_default_ppo_config().evolve(**{k: v for k, v in cfg.to_dict().items()
                                                      if k in ("model", "tokenizer", "train", "method")}),
                     reward_fn=reward_fn, devices=jax.devices()[:1])
    np_params = _perturb(jax.tree_util.tree_map(np.asarray, jt.params))
    jtree = _jax(np_params)
    jt.train_params, jt.frozen_params = partition_params(jtree, jt.make_trainable_mask(jtree))
    tt = PPOTrainer(cfg, reward_fn=reward_fn, device="cpu")
    tt.model.load_state_dict(params_from_jax(np_params, tt.model_cfg))
    jdir, tdir = tmp_path / "jax_hf", tmp_path / "torch_hf"
    jt.save_pretrained(str(jdir))
    tt.save_pretrained(str(tdir))
    extra = {"lora": [], "prompt": ["soft_prompt.npy"], "prefix": ["prefix_kv.npz"]}[kind]
    assert set(extra) <= set(os.listdir(tdir)) and set(extra) <= set(os.listdir(jdir))
    got, want = (torch.load(d / "pytorch_model.bin", weights_only=True) for d in (tdir, jdir))
    assert got.keys() == want.keys()
    for name, w in want.items():
        torch.testing.assert_close(got[name].float(), w.float(), rtol=1e-6, atol=1e-6)
    if kind == "prompt":
        np.testing.assert_array_equal(np.load(tdir / "soft_prompt.npy"), np.load(jdir / "soft_prompt.npy"))
    if kind == "prefix":
        tz, jz = np.load(tdir / "prefix_kv.npz"), np.load(jdir / "prefix_kv.npz")
        assert sorted(tz.files) == sorted(jz.files) and len(tz.files) == 4
        for name in jz.files:
            np.testing.assert_array_equal(tz[name], jz[name])
    loaded, lcfg, _ = build_model(ModelConfig(model_path=str(tdir), model_extra_configs={"dtype": "float32"}), V,
                                  device="cpu")
    assert (lcfg.lora_rank, lcfg.prompt_tokens, lcfg.prefix_tokens) == (0, 0, 0)
    tokens, mask = _t(_rows(7)[0]), _t(_rows(7)[1])
    with torch.no_grad():
        # merged: the adapter model's logits; prompt/prefix: the base's
        want_logits = tt.model.lm(tokens, mask, adapters=kind == "lora")[0]
        torch.testing.assert_close(loaded.lm(tokens, mask)[0], want_logits, rtol=1e-5, atol=1e-5)
