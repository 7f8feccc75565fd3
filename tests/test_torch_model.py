"""The port's TransformerLM (trlx_tpu_torch/models/transformer.py) against
the JAX package's on the same weights (carried by `params_from_jax`):
`prefill_rows` and `decode_step_rows` logits over a paged KV arena agree
within 1e-5 at f32, and so do the arenas they write — including the
writes JAX drops as out of bounds (right pad, inactive rows, a padding
row with an all-out-of-range table), which must leave the port's arena
unchanged too. Decode runs through the gather path and through the
paged kernel (JAX: Pallas interpret mode; port: the kernel's plain
version on the CPU)."""

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


def test_prefill_then_decode_match_jax(pair):
    jmodel, jcfg, jparams, tmodel, tcfg = pair
    rng = np.random.RandomState(0)
    S = N_TBL * BLK
    t = 16
    # row 0: 7 tokens; row 1: 16 tokens (exactly two blocks); row 2: a
    # padding row — row 0's tokens with an all-out-of-range table
    lens = [7, 16, 7]
    ids = rng.randint(0, 256, (3, t)).astype(np.int32)
    ids[2] = ids[0]
    tmask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    tables = np.asarray([[1, 2, 3, 0], [4, 5, 6, 7], [N_BLOCKS] * N_TBL], np.int32)
    zeros = np.zeros((3,), np.int32)
    j_cache = {
        "layers": [dict(l, table=jnp.asarray(tables)) for l in j_arena(jcfg, N_BLOCKS, BLK, jnp.float32)],
        "mask": jnp.zeros((3, S), jnp.int32), "pos": jnp.asarray(zeros), "row_index": jnp.asarray(zeros),
    }
    j_logits, j_new = jmodel.apply({"params": jparams}, jnp.asarray(ids), j_cache, jnp.asarray(tmask),
                                   method=type(jmodel).prefill_rows)
    t_arena = init_paged_kv_arena(tcfg, N_BLOCKS, BLK, torch.float32)
    tt = torch.from_numpy(tables)
    t_cache = {
        "layers": [dict(l, table=tt) for l in t_arena],
        "mask": torch.zeros((3, S), dtype=torch.int32),
        "pos": torch.zeros((3,), dtype=torch.long), "row_index": torch.zeros((3,), dtype=torch.long),
    }
    with torch.no_grad():
        t_logits, t_new = tmodel.prefill_rows(torch.from_numpy(ids).long(), t_cache, torch.from_numpy(tmask))
    valid = tmask.astype(bool)
    valid[2] = False  # padding row: its logits are never read
    np.testing.assert_allclose(t_logits.numpy()[valid], np.asarray(j_logits)[valid], **TOL)
    for layer in _layers(j_new["layers"], t_arena):
        for jk, tk in layer.values():
            np.testing.assert_allclose(tk, jk, **TOL)
    for key in ("mask", "pos", "row_index"):
        np.testing.assert_array_equal(t_new[key].numpy()[:2], np.asarray(j_new[key])[:2])

    # two decode steps: rows 0 and 1 active, row 2 inactive; the gather
    # path and the kernel path (Pallas interpret / plain version)
    active = np.asarray([1, 1, 0], np.int32)
    j_pool = {k: j_new[k] for k in ("mask", "pos", "row_index")}
    j_layers = [{k: v for k, v in l.items()} for l in j_new["layers"]]
    t_pool = {k: t_new[k] for k in ("mask", "pos", "row_index")}
    for step, (jk, tk) in enumerate([(None, None), ("interpret", "kernel")]):
        tok = rng.randint(0, 256, (3, 1)).astype(np.int32)
        # the inactive row keeps a stale table naming row 0's blocks
        jc = dict(j_pool, layers=[dict(l, table=jnp.asarray(tables[[0, 1, 0]])) for l in j_layers])
        j_lg, j_out = jmodel.apply({"params": jparams}, jnp.asarray(tok), jc, jnp.asarray(active[:, None]),
                                   method=type(jmodel).decode_step_rows, attn_kernel=jk)
        tc = dict(t_pool, layers=[dict(l, table=torch.from_numpy(tables[[0, 1, 0]])) for l in t_arena])
        with torch.no_grad():
            t_lg, t_out = tmodel.decode_step_rows(torch.from_numpy(tok).long(), tc,
                                                  torch.from_numpy(active[:, None]), attn_kernel=tk)
        np.testing.assert_allclose(t_lg.numpy()[:2], np.asarray(j_lg)[:2], **TOL)
        for layer in _layers(j_out["layers"], t_arena):
            for ja, ta in layer.values():
                np.testing.assert_allclose(ta, ja, **TOL)
        for key in ("mask", "pos", "row_index"):
            np.testing.assert_array_equal(t_out[key].numpy(), np.asarray(j_out[key]))
        j_pool = {k: j_out[k] for k in ("mask", "pos", "row_index")}
        j_layers = [{k: v for k, v in l.items() if k != "table"} for l in j_out["layers"]]
        t_pool = {k: t_out[k] for k in ("mask", "pos", "row_index")}
    # the zero block and the never-allocated blocks stay zero
    for layer in t_arena:
        assert not np.any(layer["k"].numpy()[[0, 8, 9]])
        assert not np.any(layer["v"].numpy()[[0, 8, 9]])


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
