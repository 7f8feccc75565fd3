"""The port's TransformerLM (trlx_tpu_torch/models/transformer.py) against
the JAX package's on the same weights (carried by `params_from_jax`):
`prefill_rows` and `decode_step_rows` logits over a paged KV arena agree
within 1e-5 at f32, and so do the arenas they write — including the
writes JAX drops as out of bounds (right pad, inactive rows, a padding
row with an all-out-of-range table), which must leave the port's arena
unchanged too. Decode runs through the gather path and through the
paged kernel (JAX: Pallas interpret mode; port: the kernel's plain
version on the CPU).

The prefill-then-decode cases are in `test_torch_model_decode.py`, so
that `--dist loadfile` hands them out after the large files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.models.transformer import init_paged_kv_arena as j_arena
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.configs import ModelConfig
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.models.transformer import init_paged_kv_arena, position_ids

# one intra-op thread: the tensors here are tiny, and the suite runs in
# several worker processes at once, which extra threads only slow down
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
V, BLK, N_TBL, N_BLOCKS = 259, 8, 4, 10


@pytest.fixture(scope="module", params=["gpt2-tiny", "llama-tiny", "bigcode-tiny"])
def pair(request):
    extra = {"dtype": "float32"}
    jmodel, jcfg, jparams = j_build_model(
        JModelConfig(model_path=f"random:{request.param}", model_extra_configs=extra),
        vocab_size=V, rng=jax.random.PRNGKey(0),
    )
    tmodel, tcfg, _ = build_model(
        ModelConfig(model_path=f"random:{request.param}", model_extra_configs=extra),
        vocab_size=V, device="cpu",
    )
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel.load_state_dict(params_from_jax(np_params, tcfg))
    return jmodel, jcfg, jparams, tmodel, tcfg


def _layers(j_layers, t_layers):
    out = []
    for jl, tl in zip(j_layers, t_layers):
        out.append({k: (np.asarray(jl[k]), tl[k][:N_BLOCKS].numpy()) for k in ("k", "v")})
    return out


def test_params_from_jax_covers_every_port_parameter(pair):
    jmodel, jcfg, jparams, tmodel, tcfg = pair
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    assert set(state) == set(tmodel.state_dict())
    k = np.asarray(jparams["lm"]["block_0"]["attn"]["q_proj"]["kernel"])
    np.testing.assert_array_equal(state["lm.block_0.attn.q_proj.weight"].numpy(), k.T)


def test_position_ids_match():
    from trlx_tpu.models.transformer import position_ids as j_position_ids

    m = np.asarray([[0, 0, 1, 1, 1], [1, 1, 1, 0, 0]], np.int32)
    np.testing.assert_array_equal(position_ids(torch.from_numpy(m)).numpy(),
                                  np.asarray(j_position_ids(jnp.asarray(m))))


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_training_forward_matches_jax(pair, attn_impl):
    """The no-cache forward (logits, values, h_split) over left-padded rows:
    the dense causal bias path and the flash path (JAX: blockwise XLA on
    the CPU; port: the kernels' plain versions)."""
    import dataclasses

    from trlx_tpu_torch.models.policy import CausalLMWithValueHead

    jmodel, jcfg, jparams, tmodel, tcfg = pair
    jm = type(jmodel)(dataclasses.replace(jcfg, attn_impl=attn_impl))
    tm = CausalLMWithValueHead(dataclasses.replace(tcfg, attn_impl=attn_impl))
    tm.load_state_dict(tmodel.state_dict())
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 256, (3, 12)).astype(np.int32)
    mask = (np.arange(12)[None, :] >= np.asarray([0, 5, 11])[:, None]).astype(np.int32)
    j_logits, j_values, j_split = jm.apply({"params": jparams}, jnp.asarray(ids), jnp.asarray(mask), None, 1)
    with torch.no_grad():
        t_logits, t_values, t_split = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask), None, 1)
    valid = mask.astype(bool)
    np.testing.assert_allclose(t_logits.numpy()[valid], np.asarray(j_logits)[valid], **TOL)
    np.testing.assert_allclose(t_values.numpy()[valid], np.asarray(j_values)[valid], **TOL)
    np.testing.assert_allclose(t_split.numpy(), np.asarray(j_split), **TOL)
