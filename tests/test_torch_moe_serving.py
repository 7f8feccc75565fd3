"""MoE through the engine against the JAX package, the cases of
`test_torch_moe.py` moved to a file of their own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so
these heavy ones fill a worker the parallelism files leave idle): greedy
streams over the fixed-slot and paged pools, the kernel and the gather
path, and the refusals of speculative decode and the HF load and export."""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.default_configs import default_grpo_config as j_default_grpo_config
from trlx_tpu.data.default_configs import default_ilql_config as j_default_ilql_config
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.data.default_configs import default_sft_config as j_default_sft_config
from trlx_tpu.inference import InferenceEngine as JEngine
from trlx_tpu.models import policy as j_policy
from trlx_tpu.models import transformer as jtf
from trlx_tpu.models.hf_interop import params_to_hf_state_dict as j_params_to_hf_state_dict
from trlx_tpu.ops import quant as j_quant
from trlx_tpu.ops import sampling as j_sampling
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.grpo_trainer import GRPOTrainer as JGRPOTrainer
from trlx_tpu.trainer.ilql_trainer import ILQLTrainer as JILQLTrainer
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu.trainer.sft_trainer import SFTTrainer as JSFTTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import ILQLBatch, PPORLBatch
from trlx_tpu_torch.data.default_configs import (
    default_grpo_config,
    default_ilql_config,
    default_ppo_config,
    default_sft_config,
)
from trlx_tpu_torch.inference import InferenceEngine
from trlx_tpu_torch.models import hf_interop, policy
from trlx_tpu_torch.models import transformer as tf
from trlx_tpu_torch.ops import quant, sampling
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer
from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer
from trlx_tpu_torch.utils import flatten_dict
from trlx_tpu_torch.utils.modeling import apply_with_moe_aux
from test_torch_moe import (  # the cases' helpers, shared with test_torch_moe.py
    MAX_NEW,
    PROMPTS,
    _np,
    _serve,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sft_pair():
    jcfg = j_default_sft_config().evolve(
        model=dict(model_path="random:moe-tiny", model_extra_configs={"dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"), train=dict(seq_length=64, total_steps=0, tracker=None, batch_size=2))
    jt = JSFTTrainer(jcfg, devices=jax.devices()[:1])
    tt = SFTTrainer(default_sft_config().evolve(**{k: v for k, v in jcfg.to_dict().items()
                                                   if k in ("model", "tokenizer", "train")}), device="cpu")
    tt.model.load_state_dict(params_from_jax(_np(jt.params), tt.model_cfg))
    return jt, tt


@pytest.mark.parametrize("paging,kernel", [(True, "auto"), (True, "xla"), (False, "auto")])
def test_engine_serves_moe_greedy_as_jax(sft_pair, paging, kernel):
    """The paged arena (the decode kernel's plain version, and the gather
    path) and the fixed-slot pool serve the MoE policy's greedy streams
    token for token as JAX's engine does."""
    jt, tt = sft_pair
    kw = dict(num_slots=2, max_prompt_len=32, kv_paging=paging, kv_block_size=8)
    gen = dict(max_new_tokens=MAX_NEW, do_sample=False, eos_token_id=10_000, pad_token_id=tt.tokenizer.pad_token_id)
    jeng = JEngine(jt.model, jt.model_cfg, jt.params, j_sampling.GenerationConfig(**gen),
                   decode_kernel="xla" if kernel == "xla" else "pallas", **kw)
    teng = InferenceEngine(tt.model, tt.model_cfg, None, sampling.GenerationConfig(**gen), decode_kernel=kernel, **kw)
    assert _serve(teng, PROMPTS) == _serve(jeng, PROMPTS)


def test_speculative_decode_under_moe_is_refused_as_in_jax(sft_pair):
    jt, tt = sft_pair
    gen = dict(max_new_tokens=4, do_sample=False, eos_token_id=10_000, pad_token_id=0)
    spec = dict(spec_k=2, spec_split=1, spec_draft_head=(np.zeros((64, 2)), np.zeros((2, 257))))
    with pytest.raises(NotImplementedError) as jerr:
        j_sampling.make_generate_fn(jt.model, jt.model_cfg, j_sampling.GenerationConfig(**gen), **spec)
    with pytest.raises(NotImplementedError) as terr:
        sampling.make_generate_fn(tt.model, tt.model_cfg, sampling.GenerationConfig(**gen), **spec)
    assert str(terr.value) == str(jerr.value)
    kw = dict(num_slots=2, max_prompt_len=32, kv_paging=True, kv_block_size=8, spec_k=2, spec_split=1)
    with pytest.raises(NotImplementedError) as jerr:
        JEngine(jt.model, jt.model_cfg, jt.params, j_sampling.GenerationConfig(**gen), **kw)
    with pytest.raises(NotImplementedError) as terr:
        InferenceEngine(tt.model, tt.model_cfg, None, sampling.GenerationConfig(**gen), **kw)
    assert str(terr.value) == str(jerr.value)


def test_hf_load_and_export_of_moe_are_refused(sft_pair, tmp_path):
    """The JAX package has no HF layout for experts (its export fails on
    the expert tensors); the port refuses load and export up front with a
    message that says so, and `save_pretrained` writes the raw state dict
    instead, as JAX's writes its parameters instead."""
    jt, tt = sft_pair
    with pytest.raises(Exception):
        j_params_to_hf_state_dict(jt.params, jt.model_cfg)
    state = tt.model.state_dict()
    for call in (lambda: hf_interop.params_to_hf_state_dict(state, tt.model_cfg),
                 lambda: hf_interop.config_to_hf(tt.model_cfg),
                 lambda: hf_interop.load_params_from_hf(str(tmp_path), tt.model_cfg, state)):
        with pytest.raises(NotImplementedError, match="MoE blocks have no HF checkpoint layout"):
            call()
    tt.save_pretrained(str(tmp_path / "export"))
    assert "model_state.pt" in os.listdir(tmp_path / "export")
