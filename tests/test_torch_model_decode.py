"""The cached prefill and decode against the JAX package, the case of
`test_torch_model.py` moved to a file of its own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so
this heavy one fills a worker the parallelism files leave idle), on the
same model pairs (gpt2-tiny, llama-tiny, bigcode-tiny)."""

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
from test_torch_model import (  # the cases' helpers, shared with test_torch_model.py
    BLK,
    N_BLOCKS,
    N_TBL,
    TOL,
    _layers,
    pair,
)

torch.set_num_threads(1)


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
