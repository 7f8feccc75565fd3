"""Policy wrappers: LM + value head, LM + ILQL heads, the hydra reference,
and the freezing utilities.

Port of the JAX package's `models/policy.py`: `CausalLMWithValueHead`
with the MLP value head or, under `num_value_layers > 0`, the deeper
value branch (`ValueBranch`: clones of the top blocks and the final norm
ending in the MLP head, fed the trunk activation entering block
`n_layers - num_value_layers`), with the training forward, the windowed
head of the PPO loss, the trunk cache's fill and the suffix resumed from
it, the cached decode steps of the sampler with the fast path's value
and activation capture, the speculative sampler's draft and verify, and
the inference engine's; `CausalLMPolicy`, the critic-free policy of
GRPO/RLOO (the LM alone, no value parameters anywhere in its state dict);
`CausalLMWithILQLHeads` (the LM with ILQL's V,
Q and target Q heads, `models/heads.py`); the frozen hydra reference
(`HydraReference`, the JAX `ref_param_subtree` with `forward_ref_suffix`,
`forward_ref_suffix_window` and `forward_ref_full`); under adapters
(`models/lora.py`) the reference is `AdapterReference`, the live LM with
its adapters off (the JAX `zero_lora` view), which copies nothing;
`forward_policy_and_ref`, `resolve_split`, `trainable_mask` and
`target_q_mask`.
"""

import copy
from typing import Dict, Optional

import torch
from torch import nn

from trlx_tpu_torch.models.heads import ILQLHeads, MLPHead
from trlx_tpu_torch.models.lora import PREFIX_NAMES, PROMPT_NAME, has_adapters, is_lora_name
from trlx_tpu_torch.models.transformer import (
    Block,
    TransformerConfig,
    TransformerLM,
    embed_inputs,
    make_norm,
    position_ids,
    train_bias,
)

_NO_VALUE_HEAD = "CausalLMPolicy has no value head; call it with with_value=False"
_NO_STEP_VALUES = ("per-step values during decode are not supported with a value branch (values are "
                   "computed in the scoring pass)")


class ValueBranch(nn.Module):
    """The deeper value head: `n` trainable blocks and a final norm, cloned
    from the trunk's top blocks after init or load (`build_model`), ending
    in the scalar MLP head (which keeps its fresh init). Fed the trunk
    activation entering block `n_layers - n`."""

    def __init__(self, cfg: TransformerConfig, n: int, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.blocks = []
        for i in range(n):
            blk = Block(cfg, device, generator)
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)
        self.ln_f = make_norm(cfg, device)
        self.v_head = MLPHead(cfg.d_model, 1, cfg.dtype, cfg.param_dtype, device, generator)

    def forward(self, h, attn_mask, positions):
        bias = train_bias(self.cfg, attn_mask)
        for blk in self.blocks:
            h, _ = blk(h, bias, positions, attn_mask=attn_mask)
        return self.v_head(self.ln_f(h))[..., 0]

    def clone_from(self, lm: TransformerLM) -> None:
        """Copy the trunk's top blocks and final norm into the branch: the
        branch owns its storage, so training either side leaves the other."""
        top = lm.cfg.n_layers - len(self.blocks)
        with torch.no_grad():
            for i, blk in enumerate(self.blocks):
                for dst, src in zip(blk.parameters(), getattr(lm, f"block_{top + i}").parameters()):
                    dst.copy_(src)
            for dst, src in zip(self.ln_f.parameters(), lm.ln_f.parameters()):
                dst.copy_(src)


class CausalLMWithValueHead(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, generator=None, num_value_layers: int = 0):
        super().__init__()
        self.cfg = cfg
        self.num_value_layers = num_value_layers
        self.value_split = cfg.n_layers - num_value_layers  # the branch's tap
        self.lm = TransformerLM(cfg, device, generator)
        if num_value_layers > 0:
            self.value_branch = ValueBranch(cfg, num_value_layers, device, generator)
        else:
            self.v_head = MLPHead(cfg.d_model, 1, cfg.dtype, cfg.param_dtype, device, generator)

    def forward(self, tokens, attn_mask, positions=None, split: int = 0):
        """Returns (logits, values, h_split). `split` is the hydra branch
        point (0: h_split is the embedding output)."""
        branch = self.num_value_layers > 0
        logits, h_split, h_final, h_value = self.lm.forward_captures(
            tokens, attn_mask, positions, split, self.value_split if branch else split)
        if branch:
            # the branch's blocks see the trunk's positions: the rotary
            # phases of the blocks they were cloned from
            if positions is None:
                positions = position_ids(attn_mask)
            return logits, self.value_branch(h_value, attn_mask, positions), h_split
        return logits, self.v_head(h_final)[..., 0], h_split

    def _no_window_under_a_branch(self, what: str) -> None:
        if self.num_value_layers > 0:
            raise NotImplementedError(f"{what} with a value branch is unsupported (branch blocks attend over "
                                      "the full sequence)")

    def forward_window(self, tokens, attn_mask, positions=None, start: int = 0, length: int = 1):
        """(logits_win, values_win) over positions [start, start + length)
        only: the slice the PPO loss reads. The MLP value head reads each
        position's hidden state on its own, so windowing it is exact; the
        value branch attends over the full sequence and cannot be
        windowed."""
        self._no_window_under_a_branch("forward_window")
        logits, h_final = self.lm.forward_window(tokens, attn_mask, positions, start, length)
        return logits, self.v_head(h_final)[..., 0]

    def forward_trunk(self, tokens, attn_mask, positions=None, split: int = 0):
        """The frozen prefix alone: embeddings and blocks [0, split), the
        activation entering the hydra split (the trunk cache's fill)."""
        return self.lm.forward_trunk(tokens, attn_mask, positions, split)

    def forward_from_cache(self, h_split, attn_mask, positions=None, start_layer: int = 0):
        """(logits, values) resuming blocks [start_layer, n_layers), the
        head and the value head (or the value branch, whose tap must lie at
        or above start_layer) from a cached trunk activation. Exact when
        the trunk is frozen, as it is under any split > 0."""
        if self.num_value_layers > 0:
            if positions is None:
                positions = position_ids(attn_mask)
            logits, _, h_value = self.lm.forward_from_captures(h_split, attn_mask, positions, start_layer,
                                                               self.value_split)
            return logits, self.value_branch(h_value, attn_mask, positions)
        logits, h_final, _ = self.lm.forward_from_captures(h_split, attn_mask, positions, start_layer)
        return logits, self.v_head(h_final)[..., 0]

    def forward_from_cache_window(self, h_split, attn_mask, positions=None, start_layer: int = 0,
                                  start: int = 0, length: int = 1):
        """`forward_from_cache` with the windowed head: (logits_win,
        values_win) over positions [start, start + length) only (the
        trunk-cache step's forward). Not under a value branch, as
        `forward_window`."""
        self._no_window_under_a_branch("forward_from_cache_window")
        logits, h_final = self.lm.forward_from_window(h_split, attn_mask, positions, start_layer, start, length)
        return logits, self.v_head(h_final)[..., 0]

    def spec_draft_step(self, tokens, cache, token_mask, split: int):
        """Trunk-only per-row draft step of self-speculative decode. Returns
        (h_split, ln_f(h_split), new_cache); no head runs."""
        return self.lm.spec_draft_step(tokens, cache, token_mask, split)

    def spec_verify_rows(self, h, cache, row_start, positions, split: int, with_value: bool = False,
                         token_mask=None):
        """Batched suffix verify from the trunk's own rows. Returns (logits,
        values or None, layers); values come from the MLP value head on
        h_final (the capture path asks for them; under a value branch the
        values come from the scoring pass, and asking raises)."""
        if with_value and self.num_value_layers > 0:
            raise NotImplementedError(_NO_STEP_VALUES)
        logits, h_final, layers = self.lm.spec_verify_rows(h, cache, row_start, positions, split, token_mask)
        values = self.v_head(h_final)[..., 0] if with_value else None
        return logits, values, layers

    def decode_step(self, tokens, cache, token_mask, is_prefill: bool = False, with_value: bool = False,
                    capture_split: Optional[int] = None):
        """Cached decode over the fixed-slot cache (the sampler's). Returns
        (logits, values, new_cache, h_cap): the value head's output when
        `with_value` (refused under a value branch), and the activation
        entering block `capture_split` when it is given (the rollout fast
        path's capture), else None."""
        if with_value and self.num_value_layers > 0:
            raise NotImplementedError(_NO_STEP_VALUES)
        out = self.lm.decode_step(tokens, cache, token_mask, is_prefill, capture_split)
        logits, h_final, new_cache = out[:3]
        values = self.v_head(h_final)[..., 0] if with_value else None
        return logits, values, new_cache, out[3] if capture_split is not None else None

    def decode_step_rows(self, tokens, cache, token_mask, attn_kernel=None):
        """Per-row-offset cached decode (continuous-batching slot pool).
        Returns (logits, new_cache)."""
        return self.lm.decode_step_rows(tokens, cache, token_mask, attn_kernel)

    def prefill_rows(self, tokens, cache, token_mask):
        """Per-row-offset multi-token prefill (the paged engine's insert
        path). Returns (logits, new_cache)."""
        return self.lm.prefill_rows(tokens, cache, token_mask)


class CausalLMPolicy(CausalLMWithValueHead):
    """The critic-free policy of GRPO/RLOO: the LM alone, with no value
    head anywhere in its state dict (a zero-initialized head would still
    hold and train parameters). It subclasses `CausalLMWithValueHead`, so
    the delegates that read only `self.lm` (the cached and row decode, the
    speculative draft), `HydraReference` and `forward_policy_and_ref` work
    unchanged; the values slot is None, and asking for a per-step value
    raises. The trunk cache's resume is not offered: GRPO's gates keep the
    cache off."""

    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.num_value_layers = 0
        self.value_split = cfg.n_layers
        self.lm = TransformerLM(cfg, device, generator)

    def forward(self, tokens, attn_mask, positions=None, split: int = 0):
        """Returns (logits, None, h_split)."""
        logits, h_split, _ = self.lm(tokens, attn_mask, positions, split)
        return logits, None, h_split

    def forward_window(self, tokens, attn_mask, positions=None, start: int = 0, length: int = 1):
        return self.lm.forward_window(tokens, attn_mask, positions, start, length)[0], None

    def spec_verify_rows(self, h, cache, row_start, positions, split: int, with_value: bool = False,
                         token_mask=None):
        if with_value:
            raise NotImplementedError(_NO_VALUE_HEAD)
        return super().spec_verify_rows(h, cache, row_start, positions, split, False, token_mask)

    def decode_step(self, tokens, cache, token_mask, is_prefill: bool = False, with_value: bool = False,
                    capture_split: Optional[int] = None):
        if with_value:
            raise NotImplementedError(_NO_VALUE_HEAD)
        return super().decode_step(tokens, cache, token_mask, is_prefill, False, capture_split)


class CausalLMWithILQLHeads(nn.Module):
    """The LM with ILQL's heads (`ILQLHeads`: V, one or two Q heads and
    their target heads) on the final hidden state."""

    def __init__(self, cfg: TransformerConfig, device=None, generator=None, two_qs: bool = True):
        super().__init__()
        self.cfg = cfg
        self.lm = TransformerLM(cfg, device, generator)
        self.ilql_heads = ILQLHeads(cfg.d_model, cfg.vocab_size, two_qs, cfg.dtype, cfg.param_dtype, device,
                                    generator)

    def forward(self, tokens, attn_mask, positions=None, states_ixs=None, actions_ixs=None):
        """Returns (logits, qs, target_qs, vs, h_final); the Q heads run on
        the action positions and the V head on the state positions when
        their index arrays are given."""
        logits, _, h_final = self.lm(tokens, attn_mask, positions, 0)
        qs, target_qs, vs = self.ilql_heads(h_final, states_ixs, actions_ixs)
        return logits, qs, target_qs, vs, h_final

    def decode_step(self, tokens, cache, token_mask, is_prefill: bool = False):
        """Cached decode returning (logits, qs, target_qs, vs, new_cache) at
        the new positions: what the sampler's beta * (Q - V) shift reads."""
        logits, h, new_cache = self.lm.decode_step(tokens, cache, token_mask, is_prefill)
        qs, target_qs, vs = self.ilql_heads(h)
        return logits, qs, target_qs, vs, new_cache

    def decode_step_rows(self, tokens, cache, token_mask, attn_kernel=None):
        """Per-row-offset cached decode (continuous-batching slot pool):
        plain-LM logits only, the advantage shift is a training-time
        sampler feature. Returns (logits, new_cache)."""
        return self.lm.decode_step_rows(tokens, cache, token_mask, attn_kernel)

    def prefill_rows(self, tokens, cache, token_mask):
        """Per-row-offset multi-token prefill (the paged engine's insert
        path). Returns (logits, new_cache)."""
        return self.lm.prefill_rows(tokens, cache, token_mask)


def resolve_split(cfg: TransformerConfig, num_layers_unfrozen: int) -> int:
    """Map `num_layers_unfrozen` to the hydra split layer: -1 = everything
    trainable (split 0), 0 = the whole LM frozen (split n_layers), k > 0 =
    the top k blocks trainable. Under any adapter the split is 0: the
    adapters change every hidden state from the first block on, so the
    reference is a whole adapters-off forward."""
    if has_adapters(cfg):
        return 0
    if num_layers_unfrozen == -1:
        return 0
    if num_layers_unfrozen == 0:
        return cfg.n_layers
    return max(cfg.n_layers - num_layers_unfrozen, 0)


def trainable_mask(model: nn.Module, cfg: TransformerConfig, num_layers_unfrozen: int) -> Dict[str, bool]:
    """{parameter name: trainable}. Heads (anything outside `lm`) are
    trainable; in the LM, -1 = all, 0 = none, k > 0 = the top k blocks and
    the final norm (and an untied lm_head) — the embeddings stay frozen,
    as the reference's freeze_bottom_causal_layers does. Under adapters
    only they (and the heads) train, whatever `num_layers_unfrozen` says
    (peft's semantics)."""
    split = resolve_split(cfg, num_layers_unfrozen)
    virtual = cfg.prompt_tokens > 0 or cfg.prefix_tokens > 0

    def _trainable(name: str) -> bool:
        parts = name.split(".")
        if parts[0] != "lm":
            return True
        if virtual:
            return parts[-1] == PROMPT_NAME or parts[-1] in PREFIX_NAMES
        if cfg.lora_rank > 0:
            return is_lora_name(name)
        if num_layers_unfrozen == -1:
            return True
        if num_layers_unfrozen == 0:
            return False
        if parts[1].startswith("block_"):
            return int(parts[1].split("_")[1]) >= split
        return parts[1] in ("ln_f", "lm_head")

    return {name: _trainable(name) for name, _ in model.named_parameters()}


def target_q_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: is a target Q head's}: those stay out of the
    optimizer and move only by the Polyak sync."""
    return {name: any(p.startswith("target_q_head") for p in name.split("."))
            for name, _ in model.named_parameters()}


class HydraReference(nn.Module):
    """The frozen reference of PPO's KL penalty: copies, taken once, of the
    LM's modules from the hydra split up (blocks [split, n_layers), the
    final norm and the unembedding, the tied embedding included), or of
    the whole LM when split is 0. The copies own their storage (the JAX
    `ref_param_subtree` copies its leaves the same way) and never take a
    gradient, so training the policy cannot move them. Submodules carry
    the LM's names, so the state dict has the JAX subtree's paths."""

    def __init__(self, lm: TransformerLM, split: int):
        super().__init__()
        cfg = self.cfg = lm.cfg
        self.split = split
        names = []
        if split == 0:
            names += ["embed_tokens"] + (["embed_pos"] if cfg.pos_embed == "learned" else [])
            names += ["ln_embed"] if cfg.embed_ln else []
        names += [f"block_{i}" for i in range(split, cfg.n_layers)] + ["ln_f"]
        head = "embed_tokens" if cfg.tie_embeddings else "lm_head"
        if head not in names:
            names.append(head)
        for name in names:
            self.add_module(name, copy.deepcopy(getattr(lm, name)))
        self.requires_grad_(False)

    def forward(self, tokens, h_split, attn_mask, positions=None):
        """Reference logits [b, t, V]: from the tokens when split is 0 (the
        JAX `forward_ref_full`), else resumed at block `split` from the
        policy's activation there (`forward_ref_suffix`)."""
        cfg = self.cfg
        if positions is None:
            positions = position_ids(attn_mask)
        if self.split == 0:
            h = embed_inputs(self, cfg, tokens, positions)
        else:
            h = h_split.detach()
        return self._suffix(h, attn_mask, positions, 0, h.shape[1])

    def forward_suffix_window(self, h_split, attn_mask, positions=None, start: int = 0, length: int = 1):
        """Reference logits over positions [start, start + length) only,
        resumed at block `split` from the activation there (the JAX
        `forward_ref_suffix_window`): the reference's own blocks [split,
        n_layers) over the full width, then its final norm and unembedding
        over the window. The rollout fast path's scorer: the sampler
        captured h_split, so the reference's suffix is all that is left."""
        if positions is None:
            positions = position_ids(attn_mask)
        return self._suffix(h_split.detach(), attn_mask, positions, start, length)

    def _suffix(self, h, attn_mask, positions, start: int, length: int):
        bias = train_bias(self.cfg, attn_mask)
        for i in range(self.split, self.cfg.n_layers):
            h, _ = getattr(self, f"block_{i}")(h, bias, positions, attn_mask=attn_mask)
        h = self.ln_f(h[:, start:start + length])
        return self.embed_tokens.attend(h) if self.cfg.tie_embeddings else self.lm_head(h)


class AdapterReference(nn.Module):
    """The reference under adapters: the live LM run with its adapters off
    (no LoRA delta, soft prompt or prefixes), the JAX `zero_lora` /
    `use_prompt=False` forward. The base weights are frozen under
    adapters, so this equals the model before training and holds no copy:
    the LM is kept outside the module tree (no parameters, an empty state
    dict). Split 0: a whole forward from the tokens."""

    split = 0

    def __init__(self, lm: TransformerLM):
        super().__init__()
        object.__setattr__(self, "_lm", lm)  # not a submodule: nothing of it to save, move or train

    def forward(self, tokens, h_split, attn_mask, positions=None):
        return self._lm(tokens, attn_mask, positions, adapters=False)[0]


def make_reference(lm: TransformerLM, split: int) -> nn.Module:
    """PPO's frozen reference: `AdapterReference` under adapters, else the
    hydra copy from `split` up."""
    return AdapterReference(lm) if has_adapters(lm.cfg) else HydraReference(lm, split)


def forward_policy_and_ref(model: CausalLMWithValueHead, ref: nn.Module, tokens, attn_mask,
                           positions: Optional[torch.Tensor] = None):
    """Policy logits and values and the frozen reference's logits: the
    trunk below the split runs once, the reference runs only its copied
    top (or, at split 0, a whole pass of its own). Returns (logits,
    values, ref_logits)."""
    logits, values, h_split = model(tokens, attn_mask, positions, ref.split)
    return logits, values, ref(tokens, h_split, attn_mask, positions).detach()
