"""Carry a JAX parameter tree into the port: `params_from_jax`.

The JAX package keeps parameters as a nested dict of arrays named after
its flax modules (`lm/block_0/attn/q_proj/kernel`, ...). The port's
modules carry the same names, so the mapping is mechanical:

- a Dense `kernel` [in, out] becomes the Linear `weight`, transposed;
- an Embed `embedding` [V, d] (`embed_tokens`, `embed_pos`) becomes `weight`;
- a norm's `scale` becomes `weight`; a `bias` stays `bias`.

The same rule carries the deeper value branch
(`value_branch/{block_i, ln_f, v_head}` -> `value_branch.block_i...`) and
ILQL's heads (`ilql_heads/{q_head_i, target_q_head_i, v_head}`). With it
the tests run both packages on the same weights.
"""

from typing import Dict

import numpy as np
import torch

_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def params_from_jax(np_params: Dict, cfg=None) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dict of numpy arrays) -> state dict for
    the port's policy modules (`CausalLMWithValueHead`, with or without
    its value branch, and `CausalLMWithILQLHeads`). With `cfg`, checks
    that the LM holds exactly `cfg.n_layers` blocks."""
    state = {}
    for path, leaf in _flatten(np_params):
        *mods, name = path
        if name not in _LEAF:
            raise KeyError(f"unexpected parameter {'/'.join(path)}")
        arr = np.array(leaf, np.float32)  # a writable copy for torch.from_numpy
        if name == "kernel":
            arr = arr.T
        state[".".join([*mods, _LEAF[name]])] = torch.from_numpy(np.ascontiguousarray(arr))
    if cfg is not None:
        blocks = {p.split(".")[1] for p in state if p.startswith("lm.block_")}
        if len(blocks) != cfg.n_layers:
            raise ValueError(f"tree holds {len(blocks)} blocks, config has {cfg.n_layers}")
    return state
