"""The port's paged InferenceEngine (trlx_tpu_torch/inference/engine.py)
on the CPU against the JAX engine on the same weights: greedy token
streams over prompts straddling block boundaries, reusing one slot and
sharing two, for the gather path and the paged kernel (JAX: "xla" and
"pallas" in interpret mode; port: "xla" and "auto", which on the CPU runs
the kernel's plain version). Greedy decoding is token-exact at f32 and
with a bf16 arena; int8 KV may differ in at most one stream at near-tie
logits (the tolerance the JAX tests grant their own two read paths).

The greedy-stream cases are in `test_torch_engine_greedy.py`, so that
`--dist loadfile` hands them out after the large files.
"""

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

# one intra-op thread: the tensors here are tiny, and the suite runs in
# several worker processes at once, which extra threads only slow down
torch.set_num_threads(1)

EOS_FREE = 10_000  # an id the byte model never emits -> length-capped runs
MAX_NEW = 8
# prompt lengths straddling the kv_block_size=8 boundaries
BOUNDARY_PROMPTS = [list(range(60, 60 + n)) for n in (7, 8, 9, 15, 16, 17)]


def _config(preset):
    from trlx_tpu.data.default_configs import default_sft_config

    return default_sft_config().evolve(
        model=dict(model_path=f"random:{preset}", model_extra_configs={"dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
        train=dict(seq_length=64, total_steps=0, tracker=None, batch_size=2),
    )


@pytest.fixture(scope="module")
def trainers():
    """(JAX trainer, port trainer) per GQA ratio, on the same weights."""
    from trlx_tpu.trainer.sft_trainer import SFTTrainer as JSFTTrainer
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    out = {}
    for preset in ("gpt2-tiny", "llama-tiny", "bigcode-tiny"):
        jcfg = _config(preset)
        jtr = JSFTTrainer(jcfg)
        ttr = SFTTrainer(TRLConfig.from_dict(jcfg.to_dict()), device="cpu")
        ttr.model.load_state_dict(
            params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params), ttr.model_cfg)
        )
        out[preset] = (jtr, ttr)
    return out


def _gen(cls, trainer):
    return cls(max_new_tokens=MAX_NEW, do_sample=False, eos_token_id=EOS_FREE,
               pad_token_id=trainer.tokenizer.pad_token_id)


def jax_engine(jtr, decode_kernel, **kw):
    return JEngine(jtr.model, jtr.model_cfg, jtr.params, _gen(JGenerationConfig, jtr),
                   num_slots=2, max_prompt_len=32, kv_paging=True, kv_block_size=8,
                   decode_kernel=decode_kernel, **kw)


def port_engine(ttr, decode_kernel, **kw):
    return InferenceEngine(ttr.model, ttr.model_cfg, None, _gen(GenerationConfig, ttr),
                           num_slots=2, max_prompt_len=32, kv_paging=True, kv_block_size=8,
                           decode_kernel=decode_kernel, **kw)


def run_serial(engine, prompts, slot=0):
    """Each prompt to completion in the SAME slot: slot reuse with block
    reclaim between requests."""
    outs = []
    for p in prompts:
        engine.insert_requests([(np.asarray(p, np.int32), MAX_NEW)], [slot])
        toks = []
        for _ in range(MAX_NEW):
            t, lp, v, f = engine.step()
            if v[slot]:
                toks.append(int(t[slot]))
            if f[slot]:
                break
        engine.reclaim_slots([slot])
        outs.append(toks)
    return outs


def run_pairs(engine, prompts):
    """Two requests at a time in two slots, inserted in one batch."""
    outs = []
    for a, b in zip(prompts[::2], prompts[1::2]):
        engine.insert_requests([(np.asarray(a, np.int32), MAX_NEW), (np.asarray(b, np.int32), MAX_NEW)], [0, 1])
        toks = {0: [], 1: []}
        for _ in range(MAX_NEW):
            t, lp, v, f = engine.step()
            for s in (0, 1):
                if v[s]:
                    toks[s].append(int(t[s]))
        engine.reclaim_slots([0, 1])
        outs += [toks[0], toks[1]]
    return outs


@pytest.mark.parametrize("kw", [
    dict(top_k=5), dict(top_p=0.9), dict(temperature=0.7, top_k=20, top_p=0.8),
    dict(min_new_tokens=3, top_p=0.95),
])
def test_logit_processing_matches_jax(kw):
    rng = np.random.RandomState(0)
    logits = (rng.randn(4, 64) * 3).astype(np.float32)
    step = np.asarray([0, 1, 2, 5])
    jcfg = JGenerationConfig(eos_token_id=7, pad_token_id=0, **kw)
    tcfg = GenerationConfig(eos_token_id=7, pad_token_id=0, **kw)
    j = np.asarray(j_process_logits(jnp.asarray(logits), jcfg, jnp.asarray(step)))
    t = process_logits(torch.from_numpy(logits), tcfg, torch.from_numpy(step)).numpy()
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    np.testing.assert_allclose(t[~np.isinf(t)], j[~np.isinf(j)], rtol=1e-6)


@pytest.mark.parametrize("k", [1, 5, 63, 64])
def test_topk_and_topp_masks_match_jax(k):
    rng = np.random.RandomState(k)
    x = rng.randn(3, 64).astype(np.float32)
    np.testing.assert_array_equal(topk_mask(torch.from_numpy(x), k).numpy(),
                                  np.asarray(j_topk_mask(jnp.asarray(x), k)))
    p = k / 64
    np.testing.assert_array_equal(topp_mask(torch.from_numpy(x), p).numpy(),
                                  np.asarray(j_topp_mask(jnp.asarray(x), p)))


def test_not_ported_options_raise(trainers):
    _, ttr = trainers["gpt2-tiny"]
    gen = _gen(GenerationConfig, ttr)
    # multi-tenant serving is ported: without a store it is refused as in JAX
    with pytest.raises(ValueError, match="multi_tenant serving needs an AdapterStore"):
        InferenceEngine(ttr.model, ttr.model_cfg, None, gen, kv_paging=True, multi_tenant=True)
    with pytest.raises(NotImplementedError, match="compile and HBM ledgers"):
        InferenceEngine(ttr.model, ttr.model_cfg, None, gen, kv_paging=True, hbm_ledger=object())
