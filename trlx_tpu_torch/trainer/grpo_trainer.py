"""GRPO / RLOO trainer: critic-free group-relative policy optimization
(port of the local path of the JAX package's `trainer/grpo_trainer.py`).

GRPO (Shao et al. 2024) samples G completions per prompt and takes the
group-standardized reward as the advantage: no value head, no GAE, no
value loss. RLOO (Ahmadian et al. 2024) is the same machinery with a
leave-one-out baseline (`method.advantage_mode="rloo"`). Both keep PPO's
clipped ratio and add the k3 KL to the frozen reference inside the loss
(`ops/ppo.py:grpo_loss`).

`GRPOTrainer` subclasses `PPOTrainer` for the rollout cycle and swaps out
what the critic touched:
- the model is `CausalLMPolicy`, with no value parameters anywhere;
- the scorer returns the reference's logprobs in the values slot (the
  loss's KL anchor), as `PPOTrainer.score` does for a critic-free policy;
- each prompt chunk holds chunk_size / G prompts, each repeated G
  adjacent times, so sampling, rewards and scoring see one row per
  completion;
- rollout elements carry a `group_id`, and advantages are normalized per
  prompt group, never per chunk.

`GRPOConfig` has none of PPO's option flags, so the PPO gates give what
the JAX gates give a GRPO trainer: no trunk cache, no speculative decode,
no int8 decode view, no capture fast path. `pipelined_cycle` is refused:
its in-graph scorer builds PPO's per-token rewards from the values, which
a critic-free policy does not have (the JAX package's cycle fails there
too).

Over the rollout fleet (`train.rollout_backend="fleet"`) only the chunk's
unique prompts travel, each with `n=G`: the server turns that into
`Scheduler.submit_n`, so a paged replica shares the prompt's KV blocks
across the group. Multi-turn episodes run in same-seed groups of G, and
each episode's total reward is group-standardized against its siblings'.
"""

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from trlx_tpu_torch.data import PPORLBatch, PPORLElement
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.models.transformer import position_ids
from trlx_tpu_torch.ops.ppo import group_relative_advantages, grpo_loss
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer, shifted_logprobs
from trlx_tpu_torch.utils import flatten_dict, infinite_dataloader
from trlx_tpu_torch.utils.modeling import add_moe_aux, apply_with_moe_aux, logprobs_of_labels

ADVANTAGE_MODES = ("grpo", "rloo")


@dataclass
@register_method
class GRPOConfig(MethodConfig):
    """The critic-free method section: the fields of the JAX package's
    GRPOConfig. The PPO-named fields keep their PPO meaning; the
    value-function fields (gamma, lam, cliprange_value, vf_coef) are gone."""

    ppo_epochs: int = 4
    num_rollouts: int = 128
    chunk_size: int = 128
    # completions per prompt (G); chunk_size and num_rollouts count
    # completions and must be divisible by it
    group_size: int = 8
    # "grpo": A_i = (r_i - mean_G) / (std_G + eps); "rloo": A_i = r_i - mean(r_{j != i})
    advantage_mode: str = "grpo"
    # the in-loss k3 KL-to-reference coefficient (GRPO eq. 3's beta)
    grpo_kl_coef: float = 0.02
    # optional PPO-style per-token KL reward shaping on top (0: pure GRPO)
    init_kl_coef: float = 0.0
    target: Optional[float] = None
    horizon: int = 10000
    cliprange: float = 0.2
    scale_reward: Optional[str] = None
    ref_mean: Optional[float] = None
    ref_std: Optional[float] = None
    cliprange_reward: float = 10.0
    gen_kwargs: dict = field(default_factory=dict)
    gen_experience_kwargs: Optional[dict] = None
    multiturn_env: Optional[str] = None
    multiturn_max_turns: int = 4
    multiturn_env_kwargs: dict = field(default_factory=dict)


@register_trainer
class GRPOTrainer(PPOTrainer):
    def __init__(self, config: TRLConfig, **kwargs):
        method = config.method
        if config.model.model_arch_type == "seq2seq":
            raise NotImplementedError("GRPO/RLOO are causal-only")
        if method.advantage_mode not in ADVANTAGE_MODES:
            raise ValueError(f"method.advantage_mode {method.advantage_mode!r} not in {ADVANTAGE_MODES}")
        G = int(method.group_size)
        if G < 1:
            raise ValueError(f"method.group_size must be >= 1, got {G}")
        if method.chunk_size % G or method.num_rollouts % G:
            raise ValueError(f"chunk_size ({method.chunk_size}) and num_rollouts ({method.num_rollouts}) must be "
                             f"divisible by group_size ({G})")
        if config.model.num_layers_unfrozen == 0:
            raise ValueError("GRPO has no value head: num_layers_unfrozen=0 would leave nothing trainable (use -1 "
                             "or a positive layer count)")
        super().__init__(config, **kwargs)
        # the running prompt-group counter: group ids stay per group across
        # chunk boundaries
        self._group_offset = 0

    def get_arch(self, config: TRLConfig):
        return build_model(config.model, vocab_size=self.tokenizer.vocab_size, seed=config.train.seed,
                           device=self.device, value_head=False)

    def make_loss_fn(self) -> Callable:
        """The clipped ratio and the in-loss KL to the reference over the
        response window: no GAE, no value loss. The windowed head where
        `_window_loss_ok` (all but prompt tuning and MoE), else the full
        forward with the labels shifted one column; under MoE the loss adds
        the load-balancing term and reports `moe_aux_loss`."""
        model = self.model
        method = self.config.method
        pad_id = self.tokenizer.pad_token_id
        window_ok = self._window_loss_ok()

        def loss_fn(batch: PPORLBatch):
            query_tensors = batch.query_tensors
            response_length = batch.rewards.shape[1]
            tokens = torch.cat([query_tensors, batch.response_tensors], dim=1)
            attention_mask = (tokens != pad_id).long()
            positions = position_ids(attention_mask)
            start = query_tensors.shape[1] - 1
            end = start + response_length
            mask = attention_mask[:, start + 1:end + 1]
            if batch.loss_masks is not None:
                # multi-turn rollouts: the environment's tokens carry no loss weight
                mask = mask * batch.loss_masks.to(mask.dtype)
            aux = 0.0
            if window_ok:
                logits_w, _ = model.forward_window(tokens, attention_mask, positions, start, response_length)
                logprobs = logprobs_of_labels(logits_w, tokens[:, start + 1:end + 1])
            else:
                (logits, _, _), aux = apply_with_moe_aux(self.model_cfg, model, tokens, attention_mask, positions)
                logprobs = shifted_logprobs(logits, tokens)[:, start:end]
            loss, stats = grpo_loss(
                logprobs=logprobs, old_logprobs=batch.logprobs, ref_logprobs=batch.values,
                advantages=batch.rewards, mask=mask, cliprange=method.cliprange, kl_coef=method.grpo_kl_coef,
            )
            loss, stats = add_moe_aux(self.model_cfg, loss, stats, aux, "losses/total_loss")
            return loss, {k: v.detach() for k, v in flatten_dict(stats).items()}

        return loss_fn

    def add_prompt_pipeline(self, pipeline):
        """Chunks of chunk_size / G prompts, each repeated G adjacent times,
        reshuffled every pass: one row per completion from here on."""
        G = int(self.config.method.group_size)
        self.prompt_pipeline = pipeline
        self._prompt_draws = 0
        base = infinite_dataloader(pipeline.create_loader(max(self.config.method.chunk_size // G, 1), shuffle=True))

        def repeat_rows(v):
            if isinstance(v, np.ndarray):
                return np.repeat(v, G, axis=0)
            return [x for x in v for _ in range(G)]

        def expanded():
            for b in base:
                yield {k: repeat_rows(v) for k, v in b.items()}

        self.prompt_iterator = expanded()

    def _chunk_to_elements(self, prompt_tensors, sample_outputs, outputs, scores, scores_mask, logprobs, values,
                           log_ratio, h_cache=None):
        """Group-relative advantages in place of per-token rewards and GAE:
        each group's G rows are adjacent, its sequence-level advantage is
        broadcast over the response tokens into the `rewards` slot (plus
        the optional per-token KL penalty of `init_kl_coef`), and `values`
        carries the reference logprobs the scorer packed there."""
        method = self.config.method
        pad_id = self.tokenizer.pad_token_id
        G = int(method.group_size)
        start = prompt_tensors.shape[1] - 1
        n_rows = len(sample_outputs)
        assert n_rows % G == 0, "chunk must hold whole prompt groups"
        sample_scores = np.where(scores_mask, scores, 0.0).sum(axis=1)
        adv = group_relative_advantages(torch.from_numpy(sample_scores.reshape(-1, G)),
                                        mode=method.advantage_mode).reshape(-1).numpy()
        kl_penalty = -self._kl_coef() * log_ratio
        elements = []
        for ix in range(n_rows):
            # an empty response keeps one (padding) slot
            n_resp = max(int((sample_outputs[ix] != pad_id).sum()), 1)
            end = start + n_resp
            elements.append(PPORLElement(
                query_tensor=prompt_tensors[ix],
                response_tensor=sample_outputs[ix, :n_resp],
                logprobs=logprobs[ix, start:end],
                values=values[ix, start:end],
                rewards=kl_penalty[ix, start:end] + adv[ix],
                group_id=self._group_offset + ix // G,
            ))
        self._group_offset += n_rows // G
        return elements

    def pipelined_cycle(self, pending=None):
        raise NotImplementedError(
            "pipelined_cycle under GRPO/RLOO is not ported (ROADMAP queue A, item 4: GRPO under pipelined_cycle): "
            "its in-graph scorer builds PPO's rewards from the values a critic-free policy does not have; use "
            "make_experience + learn"
        )

    def _multiturn_group_size(self) -> int:
        """Same-seed groups of G episodes (the multi-turn analogue of G
        completions a prompt)."""
        return int(self.config.method.group_size)

    def _multiturn_elements(self, rows, prompt_tensors, sample_outputs, loss_mask, env_rewards, logprobs, values,
                            log_ratio, start, max_r):
        """Group-relative episode advantages: each episode's total reward
        is standardized against its G same-seed siblings' and broadcast
        over the response; `values` carries the reference's logprobs (the
        in-loss KL anchor). The optional `init_kl_coef` shaping lands on
        policy tokens only."""
        method = self.config.method
        G = int(method.group_size)
        n = len(rows)
        assert n % G == 0, "multi-turn chunk must hold whole seed groups"
        totals = env_rewards.sum(axis=1)
        adv = group_relative_advantages(torch.from_numpy(totals.reshape(-1, G)),
                                        mode=method.advantage_mode).reshape(-1).numpy()
        kl_coef = self._kl_coef()
        elements = []
        for i, (_p, ids, _lm, _er, _bl, _h) in enumerate(rows):
            n_resp = max(min(len(ids), max_r), 1)
            end = start + n_resp
            lmask_row = np.asarray(loss_mask[i, :n_resp], np.float32)
            rewards = (-kl_coef * log_ratio[i, start:end]) * lmask_row
            elements.append(PPORLElement(
                query_tensor=prompt_tensors[i],
                response_tensor=sample_outputs[i, :n_resp],
                logprobs=logprobs[i, start:end],
                values=values[i, start:end],
                rewards=rewards.astype(np.float32) + adv[i],
                group_id=self._group_offset + i // G,
                loss_mask=lmask_row.copy(),
            ))
        self._group_offset += n // G
        return elements

    def _extra_resume_state(self):
        return {**super()._extra_resume_state(), "group_offset": self._group_offset}

    def _load_extra_resume_state(self, state):
        super()._load_extra_resume_state(state)
        self._group_offset = state["group_offset"]
