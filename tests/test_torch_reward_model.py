"""The port's reward model (trlx_tpu_torch/models/reward.py) against the
JAX package's `models/reward.py` on the same weights (carried by
`params_from_jax`) and the same seeded numpy inputs, f32.

Tolerances: rewards 1e-5 (gpt2-tiny and llama-tiny; the port runs the
flash kernels' plain versions, JAX its dense attention); the pairwise
loss and its stats 1e-6; its gradients against `jax.grad` 2e-5; the
parameters after 3 Adam steps on pairs 2e-5; `make_reward_fn` scores
1e-5. That the model learns separable preferences is
`test_torch_reward_learning.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trlx_tpu.data.configs import TokenizerConfig as JTokenizerConfig
from trlx_tpu.models import config_from_preset as j_config_from_preset
from trlx_tpu.models import reward as j_reward
from trlx_tpu.tokenizers import get_tokenizer as j_get_tokenizer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.configs import TokenizerConfig
from trlx_tpu_torch.models import config_from_preset
from trlx_tpu_torch.models.reward import CausalLMWithRewardHead, build_reward_model, make_reward_fn, pairwise_loss
from trlx_tpu_torch.tokenizers import get_tokenizer

torch.set_num_threads(1)

V = 64


def _pair(preset="gpt2-tiny"):
    """(JAX module, its params, its jitted apply, the port's module on the
    same weights)."""
    jcfg = j_config_from_preset(preset, vocab_size=V, dtype=jnp.float32)
    jmodel = j_reward.CausalLMWithRewardHead(jcfg)
    tokens = jnp.zeros((2, 8), jnp.int32)
    jparams = jmodel.init(jax.random.PRNGKey(0), tokens, jnp.ones_like(tokens))["params"]
    cfg = config_from_preset(preset, vocab_size=V, dtype=torch.float32, attn_impl="flash")
    model = build_reward_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg))
    return jmodel, jparams, jax.jit(jmodel.apply), model


@pytest.fixture(scope="module")
def gpt2_pair():
    return _pair()


def _loss_and_grad(apply):
    """JAX's pairwise loss over chosen and rejected rows, and its gradient,
    jitted once."""

    def loss_fn(p, c_ids, c_mask, r_ids, r_mask):
        return j_reward.pairwise_loss(apply({"params": p}, c_ids, c_mask), apply({"params": p}, r_ids, r_mask))[0]

    return jax.jit(jax.value_and_grad(loss_fn))


def _inputs(seed=0, b=4, t=10):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, V, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    for i in range(b):
        mask[i, rng.randint(1, t + 1):] = 0  # right padding, at least one token
    return ids, mask


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


@pytest.mark.parametrize("preset", ["gpt2-tiny", "llama-tiny"])
def test_rewards_match_jax(preset, gpt2_pair):
    jmodel, jparams, apply, model = gpt2_pair if preset == "gpt2-tiny" else _pair(preset)
    ids, mask = _inputs()
    want = np.asarray(apply({"params": jparams}, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(_t(ids), _t(mask)).numpy()
    assert got.shape == (4,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_params_from_jax_loads_the_reward_tree(gpt2_pair):
    jmodel, jparams, _, model = gpt2_pair
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(state["r_head.dense_out.weight"].numpy(),
                                  np.asarray(jparams["r_head"]["dense_out"]["kernel"]).T)


def test_padding_after_the_last_valid_token_changes_nothing(gpt2_pair):
    model = gpt2_pair[3]
    tokens = np.array([[5, 6, 7, 0, 0, 0, 0, 0]], np.int32)
    mask = np.array([[1, 1, 1, 0, 0, 0, 0, 0]], np.int32)
    garbage = tokens.copy()
    garbage[0, 5] = 33
    with torch.no_grad():
        assert torch.equal(model(_t(tokens), _t(mask)), model(_t(garbage), _t(mask)))


def test_pairwise_loss_stats_and_gradients_match_jax(gpt2_pair):
    jmodel, jparams, apply, model = gpt2_pair
    c_ids, c_mask = _inputs(1)
    r_ids, r_mask = _inputs(2)
    rc, rr = np.array([2.0, 0.0, -1.0], np.float32), np.array([0.0, 2.0, -3.0], np.float32)
    loss, stats = pairwise_loss(torch.from_numpy(rc), torch.from_numpy(rr))
    j_loss, j_stats = j_reward.pairwise_loss(jnp.asarray(rc), jnp.asarray(rr))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    for k in ("loss", "accuracy", "margin"):
        np.testing.assert_allclose(float(stats[k]), float(j_stats[k]), rtol=1e-6, atol=1e-7)

    j_loss, j_grads = _loss_and_grad(apply)(jparams, c_ids, c_mask, r_ids, r_mask)
    j_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, j_grads))
    model.zero_grad(set_to_none=True)
    loss, _ = pairwise_loss(model(_t(c_ids), _t(c_mask)), model(_t(r_ids), _t(r_mask)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(), rtol=2e-5, atol=2e-5, err_msg=name)


def test_three_adam_steps_on_pairs_match_jax(gpt2_pair):
    jmodel, jparams, apply, trained = gpt2_pair
    model = CausalLMWithRewardHead(trained.cfg)  # a copy: the fixture's module stays as loaded
    model.load_state_dict(trained.state_dict())
    optimizer = optax.adam(1e-3)
    opt_state = optimizer.init(jparams)
    torch_opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for step in range(3):
        c_ids, c_mask = _inputs(10 + step)
        r_ids, r_mask = _inputs(20 + step)

        def j_loss_fn(p):
            return j_reward.pairwise_loss(jmodel.apply({"params": p}, c_ids, c_mask),
                                          jmodel.apply({"params": p}, r_ids, r_mask))[0]

        # op by op, as the parameters' 2e-5 bound was set: Adam turns a
        # near-zero gradient's rounding into a step of up to lr, and XLA's
        # fusion under jit rounds some differently
        grads = jax.grad(j_loss_fn)(jparams)
        updates, opt_state = optimizer.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        torch_opt.zero_grad()
        pairwise_loss(model(_t(c_ids), _t(c_mask)), model(_t(r_ids), _t(r_mask)))[0].backward()
        torch_opt.step()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for name, p in model.state_dict().items():
        # the key projection's bias has an exactly-zero gradient: Adam turns
        # its rounding noise into +-lr steps (ROADMAP's watch list)
        tol = 3 * 1e-3 if name.endswith("k_proj.bias") else 2e-5
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=2e-5, atol=tol, err_msg=name)


def test_make_reward_fn_contract_matches_jax(gpt2_pair):
    jmodel, jparams, _, model = gpt2_pair
    # the head reads position mask.sum - 1: right padding, as the model
    # expects (left-padded, that position is a pad whose fully masked
    # attention row the port's kernels zero and JAX's dense path does not)
    tokenizer = get_tokenizer(TokenizerConfig(tokenizer_path="char:abcdefgh", padding_side="right"))
    j_tokenizer = j_get_tokenizer(JTokenizerConfig(tokenizer_path="char:abcdefgh", padding_side="right"))
    samples = ["abc", "defg", "h", "hhgfedcba", "bad"]
    fn = make_reward_fn(model, None, tokenizer, max_length=8, batch_size=2, norm_offset=0.25)
    j_fn = j_reward.make_reward_fn(jmodel, jparams, j_tokenizer, max_length=8, batch_size=2, norm_offset=0.25)
    scores, want = fn(samples), j_fn(samples)
    assert len(scores) == 5 and all(isinstance(s, float) for s in scores)
    np.testing.assert_allclose(scores, want, rtol=1e-5, atol=1e-5)
    # params given: loaded into the module first
    fresh = CausalLMWithRewardHead(model.cfg)
    np.testing.assert_allclose(make_reward_fn(fresh, model.state_dict(), tokenizer, 8)(samples),
                               np.array(scores) + 0.25, rtol=1e-6, atol=1e-6)
