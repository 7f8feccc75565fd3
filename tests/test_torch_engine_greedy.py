"""The engine's greedy streams against the JAX engine, the cases of
`test_torch_engine.py` moved to a file of their own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so
these heavy ones fill a worker the parallelism files leave idle): f32
over three presets, the Pallas kernel in interpret mode with the
dispatch counts, a bf16 arena and an int8 one."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trlx_tpu.inference import InferenceEngine as JEngine
from trlx_tpu.ops.sampling import GenerationConfig as JGenerationConfig
from trlx_tpu.ops.sampling import process_logits as j_process_logits
from trlx_tpu.ops.sampling import topp_mask as j_topp_mask
from trlx_tpu.ops.ilql import topk_mask as j_topk_mask
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.inference import InferenceEngine
from trlx_tpu_torch.ops.sampling import GenerationConfig, process_logits, topk_mask, topp_mask
from test_torch_engine import (  # the cases' helpers, shared with test_torch_engine.py
    BOUNDARY_PROMPTS,
    jax_engine,
    port_engine,
    run_pairs,
    run_serial,
    trainers,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("preset", ["gpt2-tiny", "llama-tiny", "bigcode-tiny"])
def test_greedy_equal_to_jax_f32(trainers, preset):
    jtr, ttr = trainers[preset]
    ref = run_serial(jax_engine(jtr, "xla"), BOUNDARY_PROMPTS)
    assert run_serial(port_engine(ttr, "auto"), BOUNDARY_PROMPTS) == ref
    assert run_serial(port_engine(ttr, "xla"), BOUNDARY_PROMPTS) == ref
    assert run_pairs(port_engine(ttr, "auto"), BOUNDARY_PROMPTS) == ref


def test_greedy_equal_to_jax_pallas_interpret_and_dispatch_counts(trainers):
    jtr, ttr = trainers["gpt2-tiny"]
    jeng, teng = jax_engine(jtr, "pallas"), port_engine(ttr, "pallas")
    prompts = BOUNDARY_PROMPTS[:3]
    assert run_serial(teng, prompts) == run_serial(jeng, prompts)
    j_stats, t_stats = jeng.kv_stats(), teng.kv_stats()
    assert t_stats["kv_kernel_dispatches"] == j_stats["kv_kernel_dispatches"] > 0
    assert t_stats["kv_kernel_fallbacks"] == j_stats["kv_kernel_fallbacks"] == {}
    assert t_stats == j_stats
    xla = port_engine(ttr, "xla")
    run_serial(xla, prompts[:1])
    assert xla.kv_stats()["kv_kernel_dispatches"] == 0


def test_greedy_equal_to_jax_bf16_kv(trainers):
    jtr, ttr = trainers["llama-tiny"]
    ref = run_serial(jax_engine(jtr, "xla", kv_cache_dtype="bf16"), BOUNDARY_PROMPTS)
    assert run_serial(port_engine(ttr, "auto", kv_cache_dtype="bf16"), BOUNDARY_PROMPTS) == ref


def test_greedy_int8_kv_within_one_stream(trainers):
    jtr, ttr = trainers["gpt2-tiny"]
    ref = run_serial(jax_engine(jtr, "xla", kv_cache_dtype="int8"), BOUNDARY_PROMPTS)
    out = run_serial(port_engine(ttr, "auto", kv_cache_dtype="int8"), BOUNDARY_PROMPTS)
    assert sum(a == b for a, b in zip(ref, out)) >= len(BOUNDARY_PROMPTS) - 1, (ref, out)
