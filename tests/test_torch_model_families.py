"""The model families in the port (trlx_tpu_torch/models/transformer.py:
GPT-NeoX/pythia's partial rotary and parallel residual, GPT-J's shared
norm, unbiased attention and biased head, OPT's position offset, Bloom's
ALiBi and embedding norm, GPTBigCode's MQA, Mistral's sliding window)
against the JAX package's on the same weights (`params_from_jax`).

Presets: neox-tiny, gptj-tiny, opt-tiny, bloom-tiny, bigcode-tiny, and
llama-tiny with sliding_window=8 (at lengths 6, inside the window, where
the flash kernels stay on, and 16, across it). Inputs come from numpy
seeds; everything runs at f32. Tolerances: logits 1e-5 (the same
expressions in f32; the flash path is the kernels' plain versions on the
CPU, JAX's its own CPU route); greedy streams token for token; the paged
engine's kernel-fallback counts exactly; one PPO step's loss 1e-5 and
the parameters after it 2e-5 (the key bias's unrotated dims, whose exact
gradient is 0, within Adam's +-lr, as in test_torch_ppo.py). The PPO
step is `test_torch_family_ppo.py`, the greedy sampler
`test_torch_family_sampler.py`, the paged engine
`test_torch_family_engines.py`, on this file's helpers and its
`trainers` fixture.

The flash wrapper's head-dim-256 cases are in
`test_torch_model_families_flash.py`, so that `--dist loadfile` hands
them out after the large files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.data.default_configs import default_sft_config as j_default_sft_config
from trlx_tpu.inference.engine import InferenceEngine as JEngine
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.models import transformer as jtf
from trlx_tpu.ops.sampling import GenerationConfig as JGenerationConfig
from trlx_tpu.trainer.sft_trainer import SFTTrainer as JSFTTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.configs import ModelConfig, TRLConfig
from trlx_tpu_torch.inference.engine import InferenceEngine
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.models import transformer as tf
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.ops.sampling import GenerationConfig
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
V = 259
WINDOW = 8
# (preset, extra config): every family and Mistral's window on llama-tiny
FAMILIES = {
    "neox": ("neox-tiny", {}),
    "gptj": ("gptj-tiny", {}),
    "opt": ("opt-tiny", {}),
    "bloom": ("bloom-tiny", {}),
    "bigcode": ("bigcode-tiny", {}),
    "mistral": ("llama-tiny", {"sliding_window": WINDOW}),
}


def _pair(name, attn_impl):
    preset, extra = FAMILIES[name]
    extra = dict(extra, dtype="float32", attn_impl=attn_impl)
    jmodel, jcfg, jparams = j_build_model(JModelConfig(model_path=f"random:{preset}", model_extra_configs=extra),
                                          vocab_size=V, rng=jax.random.PRNGKey(0))
    tmodel, tcfg, _ = build_model(ModelConfig(model_path=f"random:{preset}", model_extra_configs=extra),
                                  vocab_size=V, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg))
    return jcfg, jparams, tmodel, tcfg


@pytest.fixture(scope="module")
def pairs():
    return {(n, impl): _pair(n, impl) for n in FAMILIES for impl in ("xla", "flash")}


def _rows(t, seed=0):
    """Left-padded rows [3, t]: full, 3 pads, and t - 2 pads."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 256, (3, t)).astype(np.int32)
    mask = (np.arange(t)[None, :] >= np.asarray([0, 3, t - 2])[:, None]).astype(np.int32)
    return ids, mask


def _lengths(name):
    return (6, 16) if name == "mistral" else (10,)


def _jlm(jcfg, jparams, method, *args, **kw):
    return jtf.TransformerLM(jcfg).apply({"params": jparams["lm"]}, *args, method=method, **kw)


def _close(got, want, mask=None):
    got, want = np.asarray(got.detach() if torch.is_tensor(got) else got), np.asarray(want)
    if mask is not None:
        got, want = got[mask.astype(bool)], want[mask.astype(bool)]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_forwards_match_jax(pairs, name, attn_impl):
    """forward, forward_captures, forward_window and the trunk pair
    (forward_trunk, then forward_from_captures / forward_from_window) on
    left-padded rows."""
    jcfg, jparams, tmodel, tcfg = pairs[(name, attn_impl)]
    lm, L = tmodel.lm, tcfg.n_layers
    for t in _lengths(name):
        ids, mask = _rows(t)
        ji, jm, ti, tm = jnp.asarray(ids), jnp.asarray(mask), torch.from_numpy(ids).long(), torch.from_numpy(mask)
        with torch.no_grad():
            logits, h_split, h_final, h_value = lm.forward_captures(ti, tm, None, 1, 2)
            win = lm.forward_window(ti, tm, None, 2, t - 3)
            trunk = lm.forward_trunk(ti, tm, None, 1)
            resumed = lm.forward_from_captures(trunk, tm, None, 1, 1)
            resumed_win = lm.forward_from_window(trunk, tm, None, 1, 2, t - 3)
        j_logits, j_split, j_final, j_value = _jlm(jcfg, jparams, jtf.TransformerLM.forward_captures, ji, jm,
                                                   None, 1, 2)
        _close(logits, j_logits, mask)
        _close(h_split, j_split, mask)
        _close(h_final, j_final, mask)
        _close(h_value, j_value, mask)
        _close(lm(ti, tm)[0], j_logits, mask)
        j_win = _jlm(jcfg, jparams, jtf.TransformerLM.forward_window, ji, jm, None, 2, t - 3)
        for got, want in zip(win, j_win):
            _close(got, want, mask[:, 2:t - 1])
        j_trunk = _jlm(jcfg, jparams, jtf.TransformerLM.forward_trunk, ji, jm, None, 1)
        _close(trunk, j_trunk, mask)
        j_res = _jlm(jcfg, jparams, jtf.TransformerLM.forward_from_captures, j_trunk, jm, None, 1, 1)
        for got, want in zip(resumed, j_res):
            _close(got, want, mask)
        j_res_win = _jlm(jcfg, jparams, jtf.TransformerLM.forward_from_window, j_trunk, jm, None, 1, 2, t - 3)
        for got, want in zip(resumed_win, j_res_win):
            _close(got, want, mask[:, 2:t - 1])
        assert L == jcfg.n_layers


def test_family_structure(pairs):
    """The knobs reach the parameters: no ln_mlp under GPT-J's shared
    norm, no q/k/v/o biases and a biased head, OPT's two extra position
    rows, Bloom's embedding norm and no position table."""
    sd = {n: pairs[(n, "xla")][2].state_dict() for n in FAMILIES}
    assert "lm.block_0.ln_mlp.weight" not in sd["gptj"] and "lm.block_0.ln_mlp.weight" in sd["neox"]
    assert "lm.block_0.attn.q_proj.bias" not in sd["gptj"] and "lm.lm_head.bias" in sd["gptj"]
    assert "lm.lm_head.bias" not in sd["neox"] and "lm.block_0.mlp.up_proj.bias" in sd["gptj"]
    assert sd["opt"]["lm.embed_pos.weight"].shape[0] == 256 + 2
    assert "lm.ln_embed.weight" in sd["bloom"] and "lm.embed_pos.weight" not in sd["bloom"]
    assert sd["bigcode"]["lm.block_0.attn.k_proj.weight"].shape[0] == 64 // 4
    assert pairs[("neox", "xla")][3].rotary_dim == 4 and pairs[("gptj", "xla")][3].rotary_dim == 8


@pytest.mark.parametrize("name", ["opt", "bloom", "gptj"])
def test_split0_reference_embeds_as_the_lm(pairs, name):
    """The whole-LM reference (split 0) reads the positions at OPT's
    offset, applies Bloom's embedding norm and GPT-J's biased head: its
    logits equal the policy's bitwise."""
    tmodel = pairs[(name, "xla")][2]
    ids, mask = _rows(10)
    ti, tm = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    ref = HydraReference(tmodel.lm, 0)
    with torch.no_grad():
        assert torch.equal(ref(ti, None, tm), tmodel.lm(ti, tm)[0])


@pytest.mark.parametrize("name", list(tf.PRESETS))
def test_every_preset_but_moe_builds(name):
    """Every preset builds, moe-tiny's MoE MLP included; the tiny ones run."""
    cfg = tf.config_from_preset(name, vocab_size=V, dtype=torch.float32)
    assert cfg.head_dim * cfg.n_heads == cfg.d_model
    if name.endswith("-tiny"):
        lm = tf.TransformerLM(cfg)
        ids, mask = _rows(8)
        with torch.no_grad():
            logits = lm(torch.from_numpy(ids).long(), torch.from_numpy(mask))[0]
        assert logits.shape == (3, 8, V) and bool(torch.isfinite(logits).all())


def test_fused_attention_ok_matches_jax():
    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)
    for impl in ("xla", "flash"):
        for alibi in (False, True):
            for window in (None, 4, 16):
                kw = dict(base, attn_impl=impl, alibi=alibi, sliding_window=window)
                tcfg, jcfg = tf.TransformerConfig(**kw), jtf.TransformerConfig(**kw)
                for t in (None, 1, 4, 5, 16, 17):
                    assert tf.fused_attention_ok(tcfg, t) == jtf.fused_attention_ok(jcfg, t), (kw, t)


def test_bias_helpers_match_jax():
    """ALiBi on left-padded rows (a row with no valid key gets -1e9 plus
    slope * 0), the banded causal bias and the decode window term."""
    mask = np.asarray([[1, 1, 1, 1, 1, 1], [0, 0, 1, 1, 1, 1], [0, 0, 0, 0, 0, 0]], np.int32)
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    for n in (4, 6, 12, 16):
        np.testing.assert_array_equal(tf.alibi_slopes(n), jtf.alibi_slopes(n))
        np.testing.assert_array_equal(tf.alibi_bias(tm, n).numpy(), np.asarray(jtf.alibi_bias(jm, n)))
    for w in (None, 1, 3):
        np.testing.assert_array_equal(tf.causal_bias(tm, w).numpy(), np.asarray(jtf.causal_bias(jm, w)))
    for cfg_kw in (dict(alibi=True), dict(sliding_window=3), {}):
        kw = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, **cfg_kw)
        got = tf.train_bias(tf.TransformerConfig(**kw), tm)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jtf.train_bias(jtf.TransformerConfig(**kw), jm)))
    pos = np.asarray([[5], [3], [0]], np.int32)
    np.testing.assert_array_equal(tf.window_bias(torch.from_numpy(pos), tm, 3).numpy(),
                                  np.asarray(jtf.window_bias(jnp.asarray(pos), jm, 3)))


def test_decode_step_across_the_window_matches_jax_and_the_forward(pairs):
    """A prefill of 6 tokens, then single steps to 16: the window (8)
    bands the cached decode as it bands the forward."""
    jcfg, jparams, tmodel, tcfg = pairs[("mistral", "xla")]
    ids, mask = _rows(16, seed=3)
    mask[:] = 1
    ti, tm = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.no_grad():
        full = tmodel.lm(ti, tm)[0]
    cache = tf.init_kv_cache(tcfg, 3, 16, torch.float32)
    jcache = jtf.init_kv_cache(jcfg, 3, 16, jnp.float32)
    jl = jtf.TransformerLM(jcfg)
    for start, stop in [(0, 6)] + [(i, i + 1) for i in range(6, 16)]:
        with torch.no_grad():
            logits, _, cache = tmodel.lm.decode_step(ti[:, start:stop], cache, tm[:, start:stop], start == 0)
        j_logits, _, jcache = jl.apply({"params": jparams["lm"]}, jnp.asarray(ids[:, start:stop]), jcache,
                                       jnp.asarray(mask[:, start:stop]), start == 0, method=jl.decode_step)
        _close(logits, j_logits)
        np.testing.assert_allclose(logits.numpy(), full[:, start:stop].numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Greedy streams: the training sampler and the paged engine
# ---------------------------------------------------------------------------

MAX_NEW = 8
BOUNDARY_PROMPTS = [list(range(60, 60 + n)) for n in (7, 8, 9, 15, 16, 17)]


def _sft_config(name):
    preset, extra = FAMILIES[name]
    return j_default_sft_config().evolve(
        model=dict(model_path=f"random:{preset}", model_extra_configs=dict(extra, dtype="float32")),
        tokenizer=dict(tokenizer_path="byte"),
        train=dict(seq_length=64, total_steps=0, tracker=None, batch_size=2),
    )


@pytest.fixture(scope="module")
def trainers():
    out = {}
    for name in FAMILIES:
        jcfg = _sft_config(name)
        jtr = JSFTTrainer(jcfg)
        ttr = SFTTrainer(TRLConfig.from_dict(jcfg.to_dict()), device="cpu")
        ttr.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params), ttr.model_cfg))
        out[name] = (jtr, ttr)
    return out


def _engines(jtr, ttr):
    gen = lambda cls, tr: cls(max_new_tokens=MAX_NEW, do_sample=False, eos_token_id=300,
                              pad_token_id=tr.tokenizer.pad_token_id)
    kw = dict(num_slots=2, max_prompt_len=32, kv_paging=True, kv_block_size=8, decode_kernel="pallas")
    return (JEngine(jtr.model, jtr.model_cfg, jtr.params, gen(JGenerationConfig, jtr), **kw),
            InferenceEngine(ttr.model, ttr.model_cfg, None, gen(GenerationConfig, ttr), **kw))


def _serial(engine, prompts, steps=None):
    """Each prompt to completion in slot 0; `steps` counts the decode
    dispatches."""
    outs = []
    for p in prompts:
        engine.insert_requests([(np.asarray(p, np.int32), MAX_NEW)], [0])
        toks = []
        for _ in range(MAX_NEW):
            t, _, v, f = engine.step()
            if steps is not None:
                steps.append(1)
            if v[0]:
                toks.append(int(t[0]))
            if f[0]:
                break
        engine.reclaim_slots([0])
        outs.append(toks)
    return outs


# ---------------------------------------------------------------------------
# One PPO step on the families with a distinct block structure
# ---------------------------------------------------------------------------


def _reward(samples, prompts, outputs, **kw):
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) for o in outputs]


def _ppo_config(make, preset, tmp, side):
    return make().evolve(
        train=dict(seq_length=40, batch_size=4, epochs=1, total_steps=1000, eval_interval=1000,
                   checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                   logging_dir=str(tmp / side / "logs")),
        model=dict(model_path=f"random:{preset}", num_layers_unfrozen=1,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        method=dict(num_rollouts=4, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05,
                    gen_kwargs=dict(max_new_tokens=6, do_sample=False)),
    )


# ---------------------------------------------------------------------------
# The flash wrapper at GPT-J-6B's head dim
# ---------------------------------------------------------------------------
