"""The port's adapters (trlx_tpu_torch/models/lora.py and their branches in
models/transformer.py, policy.py, hf_interop.py, base_trainer.py,
ppo_trainer.py and inference/engine.py) against the JAX package's
(`tests/test_peft.py`'s cases), on the same numpy inputs and the same
weights (carried into the port by `params_from_jax`): LoRA, prompt
tuning and prefix tuning at gpt2-tiny and llama-tiny, f32. The LoRA
factors are perturbed (as training would move them) so that no check
passes on an identity adapter. The PPO, SFT, GRPO, RFT and ILQL trainer
pairs under adapters are in `test_torch_peft_trainers.py` (PPO's in
`test_torch_peft_ppo.py`), the adapter leaves and the trainable set in
`test_torch_peft_leaves.py`, both on this file's helpers.

Tolerances: forwards, reference logits and cached decode against JAX
1e-5 (f32, the same sums in another order); a prefill's last logits
against the forward 1e-4 (as `tests/test_peft.py`); the merged weights
against JAX's merge 1e-6, and the merged model's logits against the
adapter model's 1e-5; the reference against the adapters-off forward,
the adapters-off forward against zeroed LoRA factors, and the state that
a checkpoint carries: bitwise. The refusals, the learned-position guard
and the HF load under a template, the exports and the cached decode are
in `test_torch_peft_refusals.py`, `test_torch_peft_exports.py` and
`test_torch_peft_decode.py`, so that `--dist loadfile` hands them out
after the large files.
"""

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

torch.set_num_threads(1)

V = 64
PEFT = {
    "lora": {"peft_type": "LORA", "r": 4, "lora_alpha": 16},
    "prompt": {"peft_type": "PROMPT_TUNING", "num_virtual_tokens": 4},
    "prefix": {"peft_type": "PREFIX_TUNING", "num_virtual_tokens": 4},
}
PRESETS = ("gpt2-tiny", "llama-tiny")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _rows(seed=0, b=2, t=12, pad=3):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, V, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[0, :pad] = 0  # left padding
    return tokens, mask


def _perturb(np_params, scale=0.3, seed=7):
    """Nonzero LoRA factors, as training would make them (the B factors
    start at zero)."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (v + scale * rng.randn(*v.shape).astype(np.float32) if "_lora_" in k else v)
                for k, v in tree.items()}

    return walk(np_params)


@functools.lru_cache(maxsize=None)
def _jax_model(kind, preset, targets):
    """The JAX model, its config and its params as numpy, the LoRA factors
    perturbed (built once a case: the params are only read)."""
    peft = dict(PEFT[kind], **({"target_modules": list(targets)} if targets else {}))
    jcfg = j_config_from_preset(preset, vocab_size=V, dtype=jnp.float32,
                                **j_lora.lora_overrides_from_peft_config(peft))
    jmodel = JCausalLMWithValueHead(jcfg)
    tokens, mask = _rows()
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(mask))["params"]
    return jmodel, jcfg, _perturb(jax.tree_util.tree_map(np.asarray, jparams))


def _models(kind, preset, targets=None):
    """(JAX model, JAX cfg, JAX params as numpy, port model, port cfg) on
    the same weights, the LoRA factors perturbed."""
    peft = dict(PEFT[kind], **({"target_modules": targets} if targets else {}))
    jmodel, jcfg, np_params = _jax_model(kind, preset, tuple(targets) if targets else None)
    tcfg = config_from_preset(preset, vocab_size=V, dtype=torch.float32, **lora_overrides_from_peft_config(peft))
    tmodel = CausalLMWithValueHead(tcfg, generator=torch.Generator().manual_seed(0))
    state = params_from_jax(np_params, tcfg)
    assert state.keys() == tmodel.state_dict().keys()
    tmodel.load_state_dict(state)
    return jmodel, jcfg, np_params, tmodel.eval(), tcfg


def _jax(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


# ---------------------------------------------------------------------------
# The peft config and the adapter parameters
# ---------------------------------------------------------------------------


class _PeftType:
    """peft's PeftType: a str enum whose str() is "PeftType.LORA"."""

    value = "LORA"

    def __str__(self):
        return "PeftType.LORA"


@pytest.mark.parametrize("peft", [
    PEFT["lora"], PEFT["prompt"], PEFT["prefix"],
    {"peft_type": "LORA", "r": 2, "target_modules": ["q_proj", "o_proj"]},
    {"peft_type": "prefix_tuning"}, {"r": 16},
    SimpleNamespace(peft_type=_PeftType(), r=8, lora_alpha=32, target_modules=["q_proj", "v_proj"]),
    None,
])
def test_overrides_translation_matches_jax(peft):
    assert lora_overrides_from_peft_config(peft) == j_lora.lora_overrides_from_peft_config(peft)


def test_unknown_peft_type_raises_as_jax():
    for fn in (lora_overrides_from_peft_config, j_lora.lora_overrides_from_peft_config):
        with pytest.raises(ValueError, match="Unsupported peft_type 'IA3'"):
            fn({"peft_type": "IA3"})


def test_lora_factors_orientation_and_init():
    """lora_a [in, r] normal with std 1/r, lora_b [r, out] zeros, on the
    projections the targets name (here all seven of llama's)."""
    targets = ("q_proj", "k_proj", "v_proj", "o_proj", "up_proj", "gate_proj", "down_proj")
    cfg = config_from_preset("llama-tiny", vocab_size=V, dtype=torch.float32, lora_rank=8, lora_targets=targets)
    model = CausalLMWithValueHead(cfg, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    for blk in ("lm.block_0", "lm.block_1"):
        for mod in ("attn.q_proj", "attn.k_proj", "attn.v_proj", "attn.o_proj", "mlp.up_proj", "mlp.gate_proj",
                    "mlp.down_proj"):
            w, a, b = (sd[f"{blk}.{mod}.{n}"] for n in ("weight", "lora_a", "lora_b"))
            assert a.shape == (w.shape[1], 8) and b.shape == (8, w.shape[0])
            assert float(b.abs().max()) == 0.0 and 0.05 < float(a.std()) < 0.25
    assert sum(is_lora_name(n) for n in sd) == 2 * 7 * 2


# ---------------------------------------------------------------------------
# Forwards, the reference, merge and unload
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("kind", list(PEFT))
def test_forward_matches_jax(kind, preset):
    """Logits and values with the adapters on; under prompt tuning the
    caller-visible length is kept."""
    jmodel, _, np_params, tmodel, _ = _models(kind, preset)
    tokens, mask = _rows(1)
    jl, jv, _ = jmodel.apply({"params": _jax(np_params)}, jnp.asarray(tokens), jnp.asarray(mask))
    with torch.no_grad():
        tl, tv, _ = tmodel(_t(tokens), _t(mask))
    assert tl.shape == (2, 12, V) and tv.shape == (2, 12)
    _close(tl.numpy(), np.asarray(jl), 1e-5)
    _close(tv.numpy(), np.asarray(jv), 1e-5)


@pytest.mark.parametrize("preset", PRESETS)
def test_lora_init_is_identity_and_adapters_off_equals_zeroed_factors(preset):
    """B = 0 at init: the LoRA model is the base model bitwise. With
    trained factors the adapters-off forward is the forward with zeroed
    factors bitwise (a skipped delta against a delta of exactly 0.0), and
    equals JAX's `zero_lora` forward."""
    jmodel, _, np_params, tmodel, tcfg = _models("lora", preset)
    tokens, mask = _t(_rows(2)[0]), _t(_rows(2)[1])
    fresh = CausalLMWithValueHead(tcfg, generator=torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():
        assert torch.equal(fresh(tokens, mask)[0], fresh.lm(tokens, mask, adapters=False)[0])
        on = tmodel(tokens, mask)[0]
        off = tmodel.lm(tokens, mask, adapters=False)[0]
        assert not torch.allclose(on, off, atol=1e-4)
        zeroed = {k: (torch.zeros_like(v) if is_lora_name(k) else v) for k, v in tmodel.state_dict().items()}
        tmodel.load_state_dict(zeroed)
        assert torch.equal(tmodel(tokens, mask)[0], off)
    jl, _, _ = jmodel.apply({"params": j_lora.zero_lora(_jax(np_params))}, jnp.asarray(_rows(2)[0]),
                            jnp.asarray(_rows(2)[1]))
    _close(off.numpy(), np.asarray(jl), 1e-5)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("kind", list(PEFT))
def test_reference_logits_match_jax_and_are_the_adapters_off_forward(kind, preset):
    """The reference under adapters: JAX's `forward_policy_and_ref` at
    split 0 (zeroed factors, or the prompt- and prefix-free forward)
    against the port's `AdapterReference`, which holds nothing of its own
    and is the adapters-off forward of the live LM bitwise."""
    jmodel, jcfg, np_params, tmodel, tcfg = _models(kind, preset)
    tokens, mask = _rows(3)
    jp = _jax(np_params)
    ref_params = j_ref_param_subtree(jp, jcfg, 0)
    jl, _, jref = j_forward_policy_and_ref(jmodel, jp, ref_params, jnp.asarray(tokens), jnp.asarray(mask), 0)
    ref = AdapterReference(tmodel.lm)
    assert ref.split == 0 and not list(ref.parameters()) and not ref.state_dict()
    with torch.no_grad():
        got = ref(_t(tokens), None, _t(mask))
        assert torch.equal(got, tmodel.lm(_t(tokens), _t(mask), adapters=False)[0])
        assert not torch.allclose(got, tmodel(_t(tokens), _t(mask))[0], atol=1e-4)
    _close(got.numpy(), np.asarray(jref), 1e-5)


@pytest.mark.parametrize("preset", PRESETS)
def test_merge_and_unload_matches_jax(preset):
    """W + (A B)^T alpha / r against JAX's `merge_lora_into_params`; a
    plain model on the merged weights gives the LoRA model's logits."""
    _, jcfg, np_params, tmodel, tcfg = _models("lora", preset,
                                               targets=["q_proj", "v_proj", "o_proj", "down_proj"])
    merged = merge_lora_into_state_dict(tmodel.state_dict(), tcfg)
    want = params_from_jax(j_lora.merge_lora_into_params(_jax(np_params), jcfg))
    assert merged.keys() == want.keys() and not any(is_lora_name(n) for n in merged)
    for name, w in want.items():
        torch.testing.assert_close(merged[name], w, rtol=1e-6, atol=1e-6)
    plain = CausalLMWithValueHead(config_from_preset(preset, vocab_size=V, dtype=torch.float32)).eval()
    plain.load_state_dict(merged)
    tokens, mask = _t(_rows(4)[0]), _t(_rows(4)[1])
    with torch.no_grad():
        torch.testing.assert_close(plain(tokens, mask)[0], tmodel(tokens, mask)[0], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The cached decode under prompt and prefix tuning
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# What stays refused, with JAX's messages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["prompt", "prefix"])
def test_engine_refuses_prompt_and_prefix_tuning_with_jax_message(kind):
    jmodel, jcfg, np_params, tmodel, tcfg = _models(kind, "gpt2-tiny")
    gen = dict(max_new_tokens=4, eos_token_id=V - 1, pad_token_id=0, do_sample=False)
    msg = "slot-pool decode under prompt/prefix tuning is unsupported"
    with pytest.raises(NotImplementedError, match=msg):
        JInferenceEngine(jmodel, jcfg, _jax(np_params), JGenerationConfig(**gen), num_slots=2)
    for paging in (False, True):
        with pytest.raises(NotImplementedError, match=msg):
            InferenceEngine(tmodel, tcfg, None, GenerationConfig(**gen), num_slots=2, kv_paging=paging)


# ---------------------------------------------------------------------------
# Loading an HF directory into an adapter model
# ---------------------------------------------------------------------------


def _hf_dir(tmp_path, preset):
    """An HF directory of a plain model, written by the port's exporter."""
    cfg = config_from_preset(preset, vocab_size=V, dtype=torch.float32)
    model = CausalLMWithValueHead(cfg, generator=torch.Generator().manual_seed(9))
    path = tmp_path / preset
    path.mkdir()
    sd = hf_interop.params_to_hf_state_dict(model.state_dict(), cfg)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path / "pytorch_model.bin")
    (path / "config.json").write_text(__import__("json").dumps(hf_interop.config_to_hf(cfg)))
    return str(path), model


# ---------------------------------------------------------------------------
# PPO under LoRA: the checkpoint round trip, the exports, serving
# ---------------------------------------------------------------------------


def reward_fn(samples, prompts, outputs, **kw):
    return [sum(c.islower() for c in o) / max(len(o), 1) for o in outputs]


def _ppo_config(tmp, kind, side="torch", seq_length=32, **model_extra):
    return default_ppo_config().evolve(
        model=dict(model_path="random:gpt2-tiny", peft_config=PEFT[kind], num_layers_unfrozen=-1,
                   model_extra_configs={"dtype": "float32", **model_extra}),
        tokenizer=dict(tokenizer_path="byte"),
        train=dict(seq_length=seq_length, batch_size=4, tracker=None, seed=3,
                   checkpoint_dir=str(tmp / side / "ckpts"), logging_dir=str(tmp / side / "logs")),
        method=dict(num_rollouts=8, chunk_size=8, gen_kwargs=dict(max_new_tokens=6, do_sample=False)),
    )


def _injected_batch(seed=0, b=4, q=6, r=6):
    rng = np.random.RandomState(seed)
    return PPORLBatch(query_tensors=rng.randint(3, 60, (b, q)).astype(np.int64),
                      response_tensors=rng.randint(3, 60, (b, r)).astype(np.int64),
                      logprobs=rng.randn(b, r).astype(np.float32), values=rng.randn(b, r).astype(np.float32),
                      rewards=rng.randn(b, r).astype(np.float32))


def test_lora_checkpoint_round_trip_is_exact(tmp_path):
    """A LoRA PPO trainer's checkpoint: a fresh trainer loads the same
    policy and optimizer state, its reference is still the adapters-off
    forward (nothing of it rides in the checkpoint), and the next step
    is bitwise the uninterrupted one's."""
    a = PPOTrainer(_ppo_config(tmp_path, "lora", attn_impl="flash"), reward_fn=reward_fn, device="cpu")
    a.train_minibatch([_injected_batch(0)])
    a.save(str(tmp_path / "ckpt"))
    b = PPOTrainer(_ppo_config(tmp_path, "lora", "b", attn_impl="flash"), reward_fn=reward_fn, device="cpu")
    b.load(str(tmp_path / "ckpt"))
    assert not a.ref_model.state_dict() and not b.ref_model.state_dict()
    for (k, v), (k2, v2) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    assert {n for n, p in b.model.named_parameters() if p.requires_grad} == {
        n for n, p in a.model.named_parameters() if p.requires_grad}
    sa, sb = a.train_minibatch([_injected_batch(1)]), b.train_minibatch([_injected_batch(1)])
    assert sa["losses/total_loss"] == sb["losses/total_loss"]
    for (k, v), (_, v2) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(v, v2), k
    tokens = torch.from_numpy(np.concatenate([_injected_batch(2).query_tensors, _injected_batch(2).response_tensors], 1))
    mask = torch.ones_like(tokens)
    with torch.no_grad():
        assert torch.equal(b.ref_model(tokens, None, mask), b.model.lm(tokens, mask, adapters=False)[0])


def test_serving_a_lora_policy_equals_serving_its_merged_export(tmp_path):
    """The paged engine (the paged-attention kernel's plain version on the
    CPU) over the unmerged LoRA policy and over its merged export: the
    same greedy tokens, every request."""
    tt = PPOTrainer(_ppo_config(tmp_path, "lora", attn_impl="flash"), reward_fn=reward_fn, device="cpu")
    sd = {k: (v + 0.3 * torch.randn(v.shape, generator=torch.Generator().manual_seed(1)) if is_lora_name(k) else v)
          for k, v in tt.model.state_dict().items()}
    tt.model.load_state_dict(sd)
    tt.save_pretrained(str(tmp_path / "hf"))
    merged, mcfg, _ = build_model(ModelConfig(model_path=str(tmp_path / "hf"),
                                              model_extra_configs={"dtype": "float32", "attn_impl": "flash"}),
                                  V, device="cpu")
    gen = GenerationConfig(max_new_tokens=8, eos_token_id=tt.tokenizer.eos_token_id,
                           pad_token_id=tt.tokenizer.pad_token_id, do_sample=False)
    prompts = [list(b"hello there"), list(b"ab"), list(b"the quick brown fox"), list(b"q")]

    def serve(model, cfg):
        engine = InferenceEngine(model, cfg, None, gen, num_slots=4, max_prompt_len=32, kv_paging=True,
                                 kv_block_size=8, decode_kernel="auto")
        return _drive(engine, prompts)

    lora_out, merged_out = serve(tt.model, tt.model_cfg), serve(merged, mcfg)
    assert lora_out == merged_out and all(len(o) > 0 for o in lora_out)
    with torch.no_grad():
        ids = torch.tensor([prompts[2]])
        assert not torch.equal(tt.model.lm(ids, torch.ones_like(ids))[0],
                               tt.model.lm(ids, torch.ones_like(ids), adapters=False)[0])


def _drive(engine, prompts):
    """Insert every prompt into its own slot and step until all finish;
    each request's emitted tokens."""
    slots = list(range(len(prompts)))
    engine.insert_requests([(np.asarray(p, np.int32), engine.gen_cfg.max_new_tokens) for p in prompts], slots)
    toks, done = {s: [] for s in slots}, set()
    while len(done) < len(slots):
        t, _, v, f = engine.step()
        t, v = t.reshape(len(t), -1), v.reshape(len(t), -1)
        for s in slots:
            toks[s] += [int(x) for x in t[s][v[s]]]
            if f[s]:
                done.add(s)
    return [toks[s] for s in slots]
