"""Carry a JAX parameter tree into the port: `params_from_jax`.

The JAX package keeps parameters as a nested dict of arrays named after
its flax modules (`lm/block_0/attn/q_proj/kernel`, ...). The port's
modules carry the same names, so the mapping is mechanical:

- a Dense `kernel` [in, out] becomes the Linear `weight`, transposed;
- an Embed `embedding` [V, d] (`embed_tokens`, `embed_pos`) becomes `weight`;
- a norm's `scale` becomes `weight`; a `bias` stays `bias`;
- the adapters keep their JAX orientation: a LoRA leaf `<proj>_lora_a`
  [in, r] / `<proj>_lora_b` [r, out] becomes `<proj>.lora_a` /
  `<proj>.lora_b` of that projection's Linear (`attn/q_proj_lora_a` ->
  `attn.q_proj.lora_a`), and `soft_prompt`, `prefix_k` and `prefix_v`
  keep their names;
- the MoE MLP's expert tensors (`up_proj`, `gate_proj` [E, d, f],
  `down_proj` [E, f, d], `up_bias`, `down_bias`) are leaves of their own
  in both trees and come across as they are, the expert axis first; its
  `router` is a Dense like any other (`router/kernel` [d, E] ->
  `router.weight` [E, d]).

The seq2seq trees map the same way: `lm/enc_block_i` and `lm/dec_block_i`
(with `cross_attn`), the relative-bias tables
(`lm/enc_rel_bias/embedding/embedding` -> `lm.enc_rel_bias.embedding.weight`),
the untied `lm_head`, `v_head` and `ilql_heads`, and the hydra
reference's subtree (`dec_block_i`, `dec_ln_f`, `dec_rel_bias`, the head).

The same rule carries the deeper value branch
(`value_branch/{block_i, ln_f, v_head}` -> `value_branch.block_i...`) and
ILQL's heads (`ilql_heads/{q_head_i, target_q_head_i, v_head}`) and the
reward model's head (`r_head/{dense_in, dense_out}` ->
`r_head.dense_in...`, `models/reward.py`). With it the tests run both
packages on the same weights.
"""

from typing import Dict

import numpy as np
import torch

_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}
_ADAPTERS = ("soft_prompt", "prefix_k", "prefix_v")
_EXPERTS = ("up_proj", "gate_proj", "down_proj", "up_bias", "down_bias")


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def params_from_jax(np_params: Dict, cfg=None) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dict of numpy arrays) -> state dict for
    the port's modules (`CausalLMWithValueHead`, with or without its
    value branch, `CausalLMWithILQLHeads`, `CausalLMWithRewardHead` and
    the seq2seq wrappers). With `cfg`, checks that the LM holds exactly
    `cfg.n_layers` blocks (for a seq2seq config, decoder blocks, and
    `cfg.n_encoder_layers` encoder blocks)."""
    state = {}
    for path, leaf in _flatten(np_params):
        *mods, name = path
        arr = np.array(leaf, np.float32)  # a writable copy for torch.from_numpy
        if name.endswith(("_lora_a", "_lora_b")):
            key = ".".join([*mods, name[:-len("_lora_a")], name[-len("lora_a"):]])
        elif name in _ADAPTERS or name in _EXPERTS:
            key = ".".join([*mods, name])
        elif name in _LEAF:
            key = ".".join([*mods, _LEAF[name]])
            if name == "kernel":
                arr = arr.T
        else:
            raise KeyError(f"unexpected parameter {'/'.join(path)}")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if cfg is not None:
        seq2seq = getattr(cfg, "is_seq2seq", False)
        counts = [("dec_block_", cfg.n_layers), ("enc_block_", cfg.n_encoder_layers)] if seq2seq \
            else [("block_", cfg.n_layers)]
        for prefix, want in counts:
            blocks = {p.split(".")[1] for p in state if p.startswith("lm." + prefix)}
            if len(blocks) != want:
                raise ValueError(f"tree holds {len(blocks)} {prefix[:-1]}s, config has {want}")
    return state
