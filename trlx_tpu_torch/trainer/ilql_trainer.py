"""ILQL trainer: offline RL from reward-labelled samples (port of the JAX
package's `trainer/ilql_trainer.py`).

`make_experience` tokenizes the dialogues, derives each sample's state
and action index maps and puts its normalized return on its last action;
a step runs the LM with ILQL's heads selected at those indices and
`ops/ilql.py:ilql_loss`; the target Q heads stay out of the optimizer and
follow the Q heads by a Polyak sync every `steps_for_target_q_sync`
steps. Evaluation samples with the beta * (Q - V) shift
(`generate(mode="ilql")`). Under `model_arch_type="seq2seq"` each sample
is a (prompt, output) pair: the prompt feeds the encoder, the output
(from `decoder_start_token_id`, eos last) the decoder, whose positions
the index maps name (`make_experience_seq2seq`).
"""

from dataclasses import dataclass, field
from typing import Callable, Dict

import numpy as np

from trlx_tpu_torch.data import ILQLBatch
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.models import build_model, sync_target_q_heads, target_q_mask
from trlx_tpu_torch.models.transformer import position_ids
from trlx_tpu_torch.ops.ilql import ilql_loss
from trlx_tpu_torch.pipeline.offline_pipeline import (
    ILQLRolloutStorage,
    ILQLSeq2SeqRolloutStorage,
    tokenize_dialogue,
)
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base_trainer import TorchTrainer
from trlx_tpu_torch.utils import flatten_dict, logging
from trlx_tpu_torch.utils.modeling import add_moe_aux, apply_with_moe_aux

logger = logging.get_logger(__name__)


@dataclass
@register_method
class ILQLConfig(MethodConfig):
    """ILQL hyperparameters (the JAX package's ILQLConfig)."""

    tau: float = 0.7
    gamma: float = 0.99
    cql_scale: float = 0.1
    awac_scale: float = 1.0
    alpha: float = 0.001
    beta: float = 0.0
    steps_for_target_q_sync: int = 5
    two_qs: bool = True
    gen_kwargs: dict = field(default_factory=dict)


def _normalized_returns_per_sample(rewards, all_actions_ixs):
    """Mean/std-normalize scalar returns and place each on its sample's
    final action."""
    returns = np.asarray(rewards, dtype=np.float64)
    returns = returns - returns.mean()
    std = returns.std()
    if not np.isnan(std) and std > 0:
        returns = returns / (std + np.finfo(returns.dtype).eps)
    rewards_per_sample = [np.zeros(len(x), dtype=np.float32) for x in all_actions_ixs]
    for rs, ret in zip(rewards_per_sample, returns):
        rs[-1] = ret
    return rewards_per_sample


def make_experience(samples, rewards, tokenizer=None, max_length=2048, verbose=True) -> ILQLRolloutStorage:
    """Tokenize samples and shape rewards into an ILQLRolloutStorage.
    actions_ixs index the shifted sequence: position p predicts token p +
    1, so an output token at position q is the action taken at state q -
    1. A sample whose output was truncated away is skipped."""
    if verbose:
        logger.info("Collecting rollouts")
    if tokenizer is not None:
        samples = [tokenize_dialogue(s, tokenizer, max_length) for s in samples]

    all_input_ids, all_actions_ixs, all_states_ixs, all_dones, kept_rewards = [], [], [], [], []
    n_skipped = 0
    for sample, reward in zip(samples, rewards):
        length = 0
        input_ids = np.asarray([t for s in sample for t in s.tokens], dtype=np.int32)
        actions_ixs = []
        for dm in sample:
            if dm.is_output:
                actions_ixs.append(np.arange(length - 1, length + len(dm.tokens) - 1))
            length += len(dm.tokens)
        if not actions_ixs or sum(len(a) for a in actions_ixs) == 0:
            # the prompt filled max_length: no action to fit a Q function on
            n_skipped += 1
            continue
        all_input_ids.append(input_ids)
        states_ixs = np.concatenate([*actions_ixs, [length - 1]]).astype(np.int32)
        all_dones.append(np.asarray([1] * (len(states_ixs) - 1) + [0], dtype=np.int32))
        all_actions_ixs.append(np.concatenate(actions_ixs).astype(np.int32))
        all_states_ixs.append(states_ixs)
        kept_rewards.append(reward)
    if n_skipped:
        logger.warning(f"Skipped {n_skipped}/{len(samples)} samples whose outputs were entirely truncated "
                       "(prompt longer than max_length)")
    if not all_input_ids:
        raise ValueError("No usable samples: every output was truncated away; increase train.seq_length or "
                         "shorten the prompts")

    rewards_per_sample = _normalized_returns_per_sample(kept_rewards, all_actions_ixs)
    attention_mask = [np.ones(len(x), dtype=np.int32) for x in all_input_ids]
    return ILQLRolloutStorage(all_input_ids, attention_mask, rewards_per_sample, all_states_ixs, all_actions_ixs,
                              all_dones)


def make_experience_seq2seq(samples, rewards, tokenizer, max_length=2048, decoder_start_token_id=0,
                            verbose=True) -> ILQLSeq2SeqRolloutStorage:
    """Seq2seq offline ingestion: each sample is a (prompt, output) pair;
    the prompt feeds the encoder, the output becomes the decoder's actions
    (position p predicts token p + 1). The output is truncated before its
    eos is ensured, so a long one keeps its terminal eos."""
    if verbose:
        logger.info("Collecting rollouts")
    columns = [[] for _ in range(6)]  # input_ids, attention_mask, decoder_input_ids, states, actions, dones
    for prompt, output in samples:
        input_ids = np.asarray(tokenizer.encode(prompt)[:max_length], dtype=np.int32)
        out = list(tokenizer.encode(output, add_special_tokens=False))[: max_length - 2]
        if not out or out[-1] != tokenizer.eos_token_id:
            out.append(tokenizer.eos_token_id)
        actions_ixs = np.arange(len(out), dtype=np.int32)
        states_ixs = np.concatenate([actions_ixs, [len(out)]]).astype(np.int32)
        for col, x in zip(columns, (input_ids, np.ones_like(input_ids),
                                    np.asarray([decoder_start_token_id] + out, dtype=np.int32), states_ixs,
                                    actions_ixs, np.asarray([1] * (len(states_ixs) - 1) + [0], dtype=np.int32))):
            col.append(x)
    input_ids, attention_mask, decoder_input_ids, states_ixs, actions_ixs, dones = columns
    rewards_per_sample = _normalized_returns_per_sample(rewards, actions_ixs)
    return ILQLSeq2SeqRolloutStorage(input_ids, attention_mask, decoder_input_ids, rewards_per_sample, states_ixs,
                                     actions_ixs, dones)


@register_trainer
class ILQLTrainer(TorchTrainer):
    def __init__(self, config: TRLConfig, **kwargs):
        if not isinstance(config.method, ILQLConfig):
            raise ValueError("config.method must be ILQLConfig")
        super().__init__(config, **kwargs)
        self.ilql: ILQLConfig = config.method
        self.seq2seq = config.model.model_arch_type == "seq2seq"

    def get_arch(self, config: TRLConfig):
        return build_model(config.model, vocab_size=self.tokenizer.vocab_size, seed=config.train.seed,
                           device=self.device, with_ilql_heads=True, two_qs=config.method.two_qs)

    def make_trainable_mask(self) -> Dict[str, bool]:
        # the target Q heads learn only by the Polyak sync: out of the
        # optimizer, so weight decay cannot move them between syncs
        targets = target_q_mask(self.model)
        return {k: v and not targets[k] for k, v in super().make_trainable_mask().items()}

    def generate(self, input_ids, attention_mask, gen_kwargs=None, mode="ilql", capture=False, spec_k=0):
        """Q-guided sampling: the beta * (Q - V) logit shift."""
        return super().generate(input_ids, attention_mask, gen_kwargs, mode=mode, capture=capture, spec_k=spec_k)

    def _method_sampler_options(self) -> Dict:
        return {"two_qs": self.ilql.two_qs}

    def count_tokens(self, minibatch: ILQLBatch) -> int:
        return int(np.asarray(minibatch.attention_mask).sum())

    def make_loss_fn(self) -> Callable:
        model, cfg = self.model, self.ilql
        pad_id = self.tokenizer.pad_token_id

        if self.seq2seq:
            def seq2seq_loss_fn(batch):
                decoder_attn_mask = (batch.decoder_input_ids != pad_id).long()
                decoder_attn_mask[:, 0] = 1
                logits, qs, target_qs, vs, _ = model(batch.input_ids, batch.attention_mask, batch.decoder_input_ids,
                                                     decoder_attn_mask, states_ixs=batch.states_ixs,
                                                     actions_ixs=batch.actions_ixs)
                loss, stats = ilql_loss(logits, qs, target_qs, vs, batch.decoder_input_ids, batch.actions_ixs,
                                        batch.dones, batch.rewards, tau=cfg.tau, gamma=cfg.gamma,
                                        cql_scale=cfg.cql_scale, awac_scale=cfg.awac_scale, beta=cfg.beta)
                return loss, {k: v.detach() for k, v in flatten_dict(stats).items()}

            return seq2seq_loss_fn

        def loss_fn(batch: ILQLBatch):
            (logits, qs, target_qs, vs, _), aux = apply_with_moe_aux(
                self.model_cfg, model, batch.input_ids, batch.attention_mask, position_ids(batch.attention_mask),
                states_ixs=batch.states_ixs, actions_ixs=batch.actions_ixs)
            loss, stats = ilql_loss(logits, qs, target_qs, vs, batch.input_ids, batch.actions_ixs, batch.dones,
                                    batch.rewards, tau=cfg.tau, gamma=cfg.gamma, cql_scale=cfg.cql_scale,
                                    awac_scale=cfg.awac_scale, beta=cfg.beta)
            loss, stats = add_moe_aux(self.model_cfg, loss, stats, aux, "losses/loss")
            return loss, {k: v.detach() for k, v in flatten_dict(stats).items()}

        return loss_fn

    def train_minibatch(self, minibatch):
        stats = super().train_minibatch(minibatch)
        # `iter_count` is bumped after this returns: the sync follows every
        # steps_for_target_q_sync-th optimizer step
        if (self.iter_count + 1) % self.ilql.steps_for_target_q_sync == 0:
            sync_target_q_heads(self.model.ilql_heads, self.ilql.alpha)
        return stats

    def make_experience(self, samples, rewards, max_length=2048):
        if self.seq2seq:
            self.store = make_experience_seq2seq(samples, rewards, self.tokenizer, max_length,
                                                 int(self.model_cfg.decoder_start_token_id))
        else:
            self.store = make_experience(samples, rewards, self.tokenizer, max_length)

    def create_train_dataloader(self, seed_offset: int = 0):
        return self.store.create_loader(self.config.train.batch_size, shuffle=True, drop_last=False,
                                        seed=self.config.train.seed + self.iter_count + seed_offset)

    def prepare_learning(self):
        self.train_dataloader = self.create_train_dataloader()
        self.eval_dataloader = self.eval_pipeline.create_loader(self.config.train.batch_size)
        self.n_inner_epochs = 1
        self.total_steps = min(self.config.train.epochs * len(self.train_dataloader), self.config.train.total_steps)
