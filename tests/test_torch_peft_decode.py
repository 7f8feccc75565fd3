"""The cached decode under each adapter against the forward and the JAX
package, the cases of `test_torch_peft.py` moved to a file of their own
(the suite's `--dist loadfile` hands out the files with the fewest tests
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
    PRESETS,
    _close,
    _jax,
    _models,
    _rows,
    _t,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("kind", ["prompt", "prefix", "lora"])
def test_decode_matches_the_forward_and_jax(kind, preset):
    """A prefill's last logits equal the forward's (the soft prompt in the
    cache's first columns, the prefixes before the keys), a cached step
    after it equals the forward over the longer rows, and both equal JAX's
    `decode_step`."""
    jmodel, jcfg, np_params, tmodel, tcfg = _models(kind, preset)
    tokens, mask = _rows(5)
    nxt = np.asarray([[7], [9]], np.int32)
    full, fmask = np.concatenate([tokens, nxt], 1), np.concatenate([mask, np.ones((2, 1), np.int32)], 1)
    jp = _jax(np_params)
    jcache = j_init_kv_cache(jcfg, 2, 16)
    jd, _, jcache = jmodel.apply({"params": jp}, jnp.asarray(tokens), jcache, jnp.asarray(mask), True,
                                 method=JCausalLMWithValueHead.decode_step)
    jd2, _, _ = jmodel.apply({"params": jp}, jnp.asarray(nxt), jcache, jnp.ones((2, 1), jnp.int32), False,
                             method=JCausalLMWithValueHead.decode_step)
    cache = init_kv_cache(tcfg, 2, 16)
    assert cache["mask"].shape[1] == jcache["mask"].shape[1] == 16 + tcfg.prompt_tokens
    with torch.no_grad():
        d, _, cache, _ = tmodel.decode_step(_t(tokens), cache, _t(mask), is_prefill=True)
        d2, _, _, _ = tmodel.decode_step(_t(nxt), cache, torch.ones((2, 1), dtype=torch.long))
        fl = tmodel(_t(tokens), _t(mask))[0]
        fl2 = tmodel(_t(full), _t(fmask))[0]
    torch.testing.assert_close(d[:, -1], fl[:, -1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(d2[:, -1], fl2[:, -1], rtol=1e-4, atol=1e-4)
    _close(d.numpy(), np.asarray(jd), 1e-5)
    _close(d2.numpy(), np.asarray(jd2), 1e-5)
