"""PPO trainer (port of the classic local path of the JAX package's
`trainer/ppo_trainer.py`).

One cycle: sample rollouts for a chunk of prompts with the port's sampler
(`ops/sampling.py`), decode them and score them with the user's
`reward_fn` on the host, then one no-grad hydra pass over the chunk
(`score`: policy logprobs and values, and the frozen reference's logprobs
from its copy of the top blocks), per-token KL-penalized rewards into the
rollout store, and `ppo_epochs` inner epochs of clipped PPO steps with
GAE over the store. A step runs the trunk over the full sequence and the
head over the response window only (`forward_window`); under the deeper
value branch (`method.num_value_layers_unfrozen > 0`), whose blocks attend
over the full sequence, it runs the full forward and takes the window
from it (`window_from_full`).

The method options of the JAX bench's headline PPO run:
- `quantize_frozen_trunk`: the sampler reads an int8 view of the frozen
  trunk's weight matrices (`_decode_params`, quantized once; the live
  trainable parameters are read as they are);
- `speculative_decode`: the sampler drafts `spec_k` tokens a round on the
  trunk below the split through a rank-`spec_draft_rank` readout and
  verifies them with one suffix pass (`ops/sampling.py`), where the JAX
  gate allows it (`_spec_decode_available`; a refusal counts in
  `spec_decode_fallbacks`);
- `cache_trunk_activations`: after scoring, one no-grad pass of the
  frozen trunk over the chunk (`trunk_cache_fill`) stores each rollout's
  activation entering the split beside it (torch tensors on the device,
  in `trunk_cache_dtype`), and every step resumes the trainable blocks
  from it (`forward_from_cache_window`) instead of running the trunk.

`pipelined_cycle` is the JAX bench's timed schedule: one PPO iteration
with one blocking host fetch, the rollouts, their stats and rewards kept
on the device from sampling through training
(`train_epochs_from_chunk`). Its scorers, chosen per chunk:
- the speculative scorer: the hydra pass runs on the device's own
  retokenization of the raw samples (`BaseTokenizer.device_retokenize`)
  before the host has decoded them; the host's retokenization arbitrates
  and a mismatch falls back to the in-graph classic scorer
  (`_score_reward`), counted in `spec_fallbacks`;
- the capture fast path (`capture_rollout_stats`): the sampler captures
  the policy's logprobs and values and the activations entering the
  split, so scoring is the reference's suffix alone, and the captured
  activations become the trunk cache. The next cycle's rollouts are
  sampled before this cycle's training, on one-step-stale parameters,
  as in JAX.
The JAX trainer only enqueues a sampling loop and overlaps it with host
work; eager torch runs the loop (one host sync a step), so that overlap
is absent here.

The fleet backend (`train.rollout_backend="fleet"`): `make_experience`
generates each chunk on a fleet of inference replicas
(`inference/fleet.py:ReplicaRouter`), given by `rollout_fleet_urls` or
launched by the trainer itself (`rollout_fleet_supervised`: thread
replicas of `serve()` under `inference/supervisor.py:FleetSupervisor`).
A thread replica decodes on its own copy of the weights, refreshed from
one snapshot a trainer step (`_push_params_to_thread_replicas`), never on
the module the optimizer writes in place. The replicas' per-token
logprobs replace the scorer's on the rows whose retokenization round
trips (the behaviour policy's, for the PPO ratio). When the whole fleet
is down a chunk is generated locally, with a warning, and counted in
`fleet/degraded_chunks`. `pipelined_cycle` keeps generating locally.

Multi-turn rollouts (`method.multiturn_env`, fleet only): whole
environment episodes (`environments.py`) run through fleet `/chat`
sessions; each episode is one rollout whose policy turns carry
`loss_mask` 1 and their turn's reward on their last token, and whose
environment turns carry `loss_mask` 0 and no KL penalty.

Under adapters (`model.peft_config`: LoRA, prompt or prefix tuning) the
split is 0 and the reference is the live LM with its adapters off
(`models/policy.py:AdapterReference`), so the trunk cache, the capture
fast path and speculative decode are off; under prompt tuning the loss
reads the full forward (the soft prompt shifts every position). LoRA runs
under the fleet backend too: the thread replicas take the adapter
factors with the rest of the state dict. Prompt and prefix tuning fail
there where JAX's do, at a replica's engine build.

Seq2seq (`model.model_arch_type="seq2seq"`, the JAX trainer's seq2seq
branches): the prompt is the encoder's input and the response the
decoder's, starting with `decoder_start_token_id`, so every window is
decoder-relative (start 0, the stats one shorter than the response). The
scorer (`score_seq2seq`) runs the policy and the decoder's hydra
reference (`models/seq2seq.py`); both logprobs and the loss's go through
the label logprob kernel on the full decoder logits (`shifted_logprobs`).
The pipelined cycle runs with the classic scorer (`_score_reward`, the
JAX `score_reward_s2s`, whose documented divergence from the reference's
indexing it keeps: the scalar score lands on the last real response
token and the KL mask is the decoder mask shifted with the labels).
Speculative decode, the int8 decode view, the trunk cache, the
speculative scorer and the capture fast path are off, as JAX's gates
turn them off; the fleet backend generates locally with a warning, and
multi-turn rollouts are refused.
"""

import dataclasses
import json
import os
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from trlx_tpu_torch.data import PPORLBatch, PPORLElement
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.models import build_model, make_reference
from trlx_tpu_torch.models.policy import forward_policy_and_ref
from trlx_tpu_torch.models.seq2seq import forward_seq2seq_policy_and_ref
from trlx_tpu_torch.models.transformer import position_ids
from trlx_tpu_torch.ops import quant
from trlx_tpu_torch.ops.ppo import AdaptiveKLController, FixedKLController, get_advantages_and_returns, ppo_loss
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.sentinel import repetition_frac
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base_trainer import TorchTrainer
from trlx_tpu_torch.utils import Clock, flatten_dict, infinite_dataloader, logging
from trlx_tpu_torch.utils.modeling import RunningMoments, add_moe_aux, apply_with_moe_aux, logprobs_of_labels

logger = logging.get_logger(__name__)


@dataclass
@register_method
class PPOConfig(MethodConfig):
    """PPO hyperparameters: every field of the JAX package's PPOConfig, so
    configs carry over (the flags of features not ported yet are refused
    by `PPOTrainer`)."""

    ppo_epochs: int = 4
    num_rollouts: int = 128
    chunk_size: int = 128
    init_kl_coef: float = 0.001
    target: Optional[float] = None
    horizon: int = 10000
    gamma: float = 1.0
    lam: float = 0.95
    cliprange: float = 0.2
    cliprange_value: float = 0.2
    vf_coef: float = 1.0
    scale_reward: Optional[str] = None
    ref_mean: Optional[float] = None
    ref_std: Optional[float] = None
    cliprange_reward: float = 10.0
    gen_kwargs: dict = field(default_factory=dict)
    gen_experience_kwargs: Optional[dict] = None
    num_value_layers_unfrozen: int = 0
    capture_rollout_stats: bool = False
    cache_trunk_activations: bool = False
    trunk_cache_dtype: str = "bfloat16"
    whiten_with_mask: bool = False
    speculative_decode: bool = False
    spec_k: int = 4
    spec_draft_rank: int = 64
    quantize_frozen_trunk: bool = False
    multiturn_env: Optional[str] = None
    multiturn_max_turns: int = 4
    multiturn_env_kwargs: dict = field(default_factory=dict)


def _host(x) -> np.ndarray:
    """A sampling dict's entry on the host: the local sampler's are device
    tensors, the fleet's numpy arrays."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def shifted_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """logprob of tokens[:, i + 1] under logits[:, i], [b, t - 1]. The
    label logprob reads the full, contiguous logits with the labels shifted
    one column (the last column gets an in-range id and is dropped), so the
    [b, t - 1, V] slice is never copied."""
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    return logprobs_of_labels(logits, labels)[:, :-1]


@register_trainer
class PPOTrainer(TorchTrainer):
    def __init__(self, config: TRLConfig, **kwargs):
        self.seq2seq = config.model.model_arch_type == "seq2seq"
        super().__init__(config, **kwargs)
        self.store = PPORolloutStorage(self.tokenizer.pad_token_id, self.tokenizer.padding_side)
        # the frozen reference: copies of the top of the model at init
        # (hydra), or under adapters the live LM with its adapters off
        self.ref_model = make_reference(self.model.lm, self.split)
        method = config.method
        if method.target is not None:
            self.kl_ctl = AdaptiveKLController(method.init_kl_coef, method.target, method.horizon)
        else:
            self.kl_ctl = FixedKLController(method.init_kl_coef)
        self.running_moments = RunningMoments()
        self.ref_mean = method.ref_mean
        self.ref_std = method.ref_std
        self.mean_kl = 0.0
        self.generate_experience_kwargs = method.gen_experience_kwargs
        self.prompt_pipeline = None
        self.prompt_iterator = None
        self._prompt_draws = 0
        # speculative decode: JAX-gate refusals while the flag is on, and
        # the running round and accepted-draft totals
        self.spec_decode_fallbacks = 0
        self.spec_decode_rounds = 0
        self.spec_decode_accepted = 0
        self._spec_draft_head_cache = None
        self._quant_frozen = None
        # the pipelined cycle: speculative-scorer misses, dense rewards seen
        # (which turn that scorer off), the scorer of the pending chunks,
        # and the last cycle's host timings
        self.spec_fallbacks = 0
        self._spec_disabled_dense = False
        self._pending_fast = False
        self.cycle_stats: Dict[str, float] = {}
        # the fleet backend: built at the first fleet collection; the
        # weights' snapshot the thread replicas decode on, and its step
        self._rollout_router = None
        self._rollout_supervisor = None
        self._fleet_params: Optional[Dict[str, torch.Tensor]] = None
        self._fleet_params_step: Optional[int] = None
        # multi-turn: the next episode seed
        self._mt_seed_offset = 0
        self.log_rollouts = config.train.rollout_logging_dir is not None
        if self.log_rollouts:
            self.setup_rollout_logging(config)

    def get_arch(self, config: TRLConfig):
        return build_model(config.model, vocab_size=self.tokenizer.vocab_size, seed=config.train.seed,
                           device=self.device, num_value_layers=config.method.num_value_layers_unfrozen)

    def setup_rollout_logging(self, config):
        if not os.path.isdir(config.train.rollout_logging_dir):
            raise FileNotFoundError(f"train.rollout_logging_dir {config.train.rollout_logging_dir} does not exist")
        self.run_id = f"run-{uuid.uuid4()}"
        self.rollout_logging_dir = os.path.join(config.train.rollout_logging_dir, self.run_id)
        os.mkdir(self.rollout_logging_dir)
        with open(os.path.join(self.rollout_logging_dir, "config.json"), "w") as f:
            f.write(json.dumps(config.to_dict(), indent=2, default=str))

    # ------------------------------------------------------------------
    # Loss
    # ------------------------------------------------------------------

    def count_tokens(self, minibatch: PPORLBatch) -> int:
        """The real query and response tokens (the loss's attention mask)."""
        pad_id = self.tokenizer.pad_token_id
        return int((np.asarray(minibatch.query_tensors) != pad_id).sum()
                   + (np.asarray(minibatch.response_tensors) != pad_id).sum())

    def _window_loss_ok(self) -> bool:
        """Whether the loss may read the windowed head: the plain MLP value
        head (the branch's blocks attend over the full sequence), no soft
        prompt (it shifts every position) and no MoE (the load-balancing
        term's means cover every position of the full forward)."""
        return (getattr(self.config.method, "num_value_layers_unfrozen", 0) == 0
                and self.model_cfg.prompt_tokens == 0 and self.model_cfg.moe_experts == 0)

    def make_loss_fn(self) -> Callable:
        model = self.model
        method = self.config.method
        pad_id = self.tokenizer.pad_token_id
        window_ok = self._window_loss_ok()

        if self.seq2seq:
            def seq2seq_loss_fn(batch: PPORLBatch):
                """The encoder reads the query, the decoder the response
                (its start token first); the stats are decoder-relative."""
                query_tensors, response_tensors = batch.query_tensors, batch.response_tensors
                response_length = batch.rewards.shape[1]
                attention_mask = (query_tensors != pad_id).long()
                decoder_attention_mask = (response_tensors != pad_id).long()
                decoder_attention_mask[:, 0] = 1
                mask = decoder_attention_mask[:, 1:][:, :response_length]
                advantages, returns = get_advantages_and_returns(
                    batch.values, batch.rewards, method.gamma, method.lam,
                    mask=mask if method.whiten_with_mask else None,
                )
                logits, values_pred, _, _ = model(query_tensors, attention_mask, response_tensors,
                                                  decoder_attention_mask)
                loss, stats = ppo_loss(
                    logprobs=shifted_logprobs(logits, response_tensors)[:, :response_length],
                    values=values_pred[:, :-1][:, :response_length], old_logprobs=batch.logprobs,
                    old_values=batch.values, advantages=advantages, returns=returns, mask=mask,
                    cliprange=method.cliprange, cliprange_value=method.cliprange_value, vf_coef=method.vf_coef,
                )
                return loss, {k: v.detach() for k, v in flatten_dict(stats).items()}

            return seq2seq_loss_fn

        def loss_fn(batch: PPORLBatch):
            query_tensors = batch.query_tensors
            old_logprobs, old_values, old_rewards = batch.logprobs, batch.values, batch.rewards
            response_length = old_rewards.shape[1]

            tokens = torch.cat([query_tensors, batch.response_tensors], dim=1)
            attention_mask = (tokens != pad_id).long()
            positions = position_ids(attention_mask)
            start = query_tensors.shape[1] - 1
            end = start + response_length
            mask = attention_mask[:, start + 1:end + 1]
            if batch.loss_masks is not None:
                # multi-turn rollouts: the environment's tokens are context,
                # not actions: no loss weight, out of masked whitening
                mask = mask * batch.loss_masks.to(mask.dtype)

            advantages, returns = get_advantages_and_returns(
                old_values, old_rewards, method.gamma, method.lam,
                mask=mask if method.whiten_with_mask else None,
            )

            # the windowed head reads exactly the response window of the
            # [b, t, V] logits; under the value branch the full forward runs
            aux = 0.0
            if batch.h_split is not None:
                # the trunk cache: resume the trainable blocks from the
                # activation entering the split. Exact: the trunk is frozen
                # (split > 0), and the zero rows of collation padding sit
                # at masked columns, whose exp(-1e9) is exactly 0
                h0 = batch.h_split.detach().to(self.model_cfg.dtype)
                if window_ok:
                    out = model.forward_from_cache_window(h0, attention_mask, positions, self.split, start,
                                                          response_length)
                else:
                    out = model.forward_from_cache(h0, attention_mask, positions, self.split)
            elif window_ok:
                out = model.forward_window(tokens, attention_mask, positions, start, response_length)
            else:
                out, aux = apply_with_moe_aux(self.model_cfg, model, tokens, attention_mask, positions)
                out = out[:2]
            if window_ok:
                logprobs = logprobs_of_labels(out[0], tokens[:, start + 1:end + 1])
                values_pred = out[1]
            else:  # window_from_full: the full logits with labels shifted one column (no slice copy)
                logprobs, values_pred = shifted_logprobs(out[0], tokens)[:, start:end], out[1][:, start:end]

            loss, stats = ppo_loss(
                logprobs=logprobs, values=values_pred, old_logprobs=old_logprobs, old_values=old_values,
                advantages=advantages, returns=returns, mask=mask, cliprange=method.cliprange,
                cliprange_value=method.cliprange_value, vf_coef=method.vf_coef,
            )
            loss, stats = add_moe_aux(self.model_cfg, loss, stats, aux, "losses/total_loss")
            return loss, {k: v.detach() for k, v in flatten_dict(stats).items()}

        return loss_fn

    # ------------------------------------------------------------------
    # Experience collection
    # ------------------------------------------------------------------

    @torch.no_grad()
    def score(self, all_tokens: torch.Tensor):
        """The no-grad hydra pass over a chunk of query|response tokens
        [b, t] on the device: (logprobs [b, t-1], values [b, t-1], masked
        log_ratio against the reference [b, t-1], mean_kl, mean_kl_per_token),
        the last two as 0-d tensors. A critic-free policy (GRPO/RLOO) has no
        values: that slot carries the reference's logprobs, its loss's KL
        anchor."""
        attention_mask = (all_tokens != self.tokenizer.pad_token_id).long()
        positions = position_ids(attention_mask)
        logits, values, ref_logits = forward_policy_and_ref(
            self.model, self.ref_model, all_tokens, attention_mask, positions
        )
        logprobs = shifted_logprobs(logits, all_tokens)
        ref_logprobs = shifted_logprobs(ref_logits, all_tokens)
        log_ratio = (logprobs - ref_logprobs) * attention_mask[:, :-1]
        kl = torch.exp(log_ratio) - 1 - log_ratio
        second = ref_logprobs if values is None else values[:, :-1]
        return logprobs, second, log_ratio, kl.sum(1).mean(), kl.mean()

    @torch.no_grad()
    def score_seq2seq(self, query: torch.Tensor, response: torch.Tensor):
        """The seq2seq scoring pass over a chunk of queries [b, q] (the
        encoder's input) and responses [b, 1 + r] (the decoder's, its start
        token first), on the device: `score`'s tuple, decoder-relative
        ([b, r] each); the start column is always attended."""
        pad_id = self.tokenizer.pad_token_id
        attention_mask = (query != pad_id).long()
        decoder_attention_mask = (response != pad_id).long()
        decoder_attention_mask[:, 0] = 1
        logits, values, ref_logits = forward_seq2seq_policy_and_ref(
            self.model, self.ref_model, query, attention_mask, response, decoder_attention_mask)
        logprobs = shifted_logprobs(logits, response)
        ref_logprobs = shifted_logprobs(ref_logits, response)
        log_ratio = (logprobs - ref_logprobs) * decoder_attention_mask[:, 1:]
        kl = torch.exp(log_ratio) - 1 - log_ratio
        return logprobs, values[:, :-1], log_ratio, kl.sum(1).mean(), kl.mean()

    def make_experience(self, num_rollouts: int = 1024, iter_count: int = 0):
        """Collect rollouts: generate (locally, or on the rollout fleet) ->
        decode and reward on the host -> the hydra scoring pass (and the
        trunk cache's fill) -> per-token KL-penalized rewards -> store.
        Under `method.multiturn_env`, whole episodes instead
        (`make_experience_multiturn`)."""
        if getattr(self.config.method, "multiturn_env", None):
            return self.make_experience_multiturn(num_rollouts, iter_count)
        logger.info("Collecting rollouts")
        clock = Clock()
        elements: List[PPORLElement] = []
        accumulated_stats: List[Dict] = []
        gen_kwargs = self.generate_experience_kwargs or self.generate_kwargs
        use_fleet = self._fleet_rollouts_enabled()
        while len(elements) < num_rollouts:
            if self._watchdog is not None:
                # a rollout chunk is a legitimate long gap between step
                # boundaries: each one is a heartbeat
                self._watchdog.beat()
            stats: Dict[str, float] = {}
            batch = self._next_prompts()
            n_this = len(np.asarray(batch["input_ids"]))
            clock.tick()
            if use_fleet:
                out = self._fleet_generate(batch, gen_kwargs, trainer_step=iter_count)
            else:
                out = self.generate(batch["input_ids"], batch["attention_mask"], gen_kwargs,
                                    spec_k=self._spec_k_effective())
            samples = _host(out["samples"])
            stats["time/rollout_generate"] = clock.tick()
            # throughput over the real generated tokens (padding after eos
            # does not count); tick() returns ms
            gen_s = max(stats["time/rollout_generate"] / 1000.0, 1e-9)
            stats["throughput/rollout_tokens_per_s"] = int(_host(out["response_mask"]).sum()) / gen_s
            stats["throughput/rollout_requests_per_s"] = n_this / gen_s
            self._accum_spec_stats(out, stats)

            prompt_tensors, sample_outputs, outputs, scores, scores_mask = self._host_process_chunk(
                batch, samples, stats, clock
            )
            to_device = lambda a: torch.from_numpy(a).to(self.device).long()
            h_cache = None
            if self.seq2seq:
                scored = self.score_seq2seq(to_device(prompt_tensors), to_device(sample_outputs))
            else:
                all_tokens = to_device(np.concatenate([prompt_tensors, sample_outputs], axis=1))
                scored = self.score(all_tokens)
                # the trunk cache over the same retokenized tokens the scorer saw
                h_cache = self.trunk_cache_fill(all_tokens) if self._trunk_cache_available() else None
            logprobs, values, log_ratio = (x.cpu().numpy() for x in scored[:3])
            mean_kl, mean_kl_per_token = float(scored[3]), float(scored[4])
            if use_fleet:
                # both keys on every chunk (the averaging below reads the
                # last chunk's keys), degraded chunks included
                fleet = bool(out.get("fleet"))
                hits = self._apply_behavior_logprobs(logprobs, out, prompt_tensors, sample_outputs) if fleet else 0
                stats["fleet/behavior_logprob_rows"] = float(hits)
                stats["fleet/degraded_chunks"] = 0.0 if fleet else 1.0
            chunk = self._chunk_to_elements(
                prompt_tensors, sample_outputs, outputs, scores, scores_mask, logprobs, values, log_ratio,
                h_cache,
            )
            if self._sentinel is not None:
                # the rollout quarantine and the anomaly watch, on the
                # elements (dropping rows leaves the scorer's shapes); the
                # keys are set on every chunk (the averaging below reads
                # the last chunk's keys), and an under-filled collection
                # draws another chunk
                chunk, n_dropped = self._quarantine_elements(chunk, scores, scores_mask, outputs)
                stats["sentinel/quarantined_rows"] = float(n_dropped)
                stats["rollout/entropy"] = float(np.mean([-np.mean(e.logprobs) for e in chunk])) if chunk else 0.0
                self._sentinel.observe_rollout(stats)
            elements.extend(chunk)
            stats["time/rollout_time"] = clock.tick()
            stats["policy/sqrt_kl"] = float(np.sqrt(max(mean_kl, 0.0)))
            stats["policy/kl_per_token"] = float(np.sqrt(max(mean_kl_per_token, 0.0)))
            accumulated_stats.append(stats)
            logger.info(f"[rollout {len(elements)} / {num_rollouts}]")

        stats = {k: sum(xs[k] for xs in accumulated_stats) / len(accumulated_stats) for k in accumulated_stats[-1]}
        stats["kl_ctl_value"] = self.kl_ctl.value
        if use_fleet:
            stats.update(self._fleet_stats())
        self.mean_kl = stats["policy/sqrt_kl"] ** 2
        self.tracker.log(stats, step=iter_count)
        self.push_to_store(elements)

    def _score_samples(self, str_samples, str_prompts, str_outputs, metadata):
        """reward_fn over a decoded chunk -> one score row per sample (length
        1 for a scalar reward, more for dense rewards)."""
        rows = self.reward_fn(samples=str_samples, prompts=str_prompts, outputs=str_outputs,
                              tokenizer=self.tokenizer, **metadata)
        return [np.atleast_1d(np.asarray(r, dtype=np.float32)) for r in rows]

    def _host_process_chunk(self, batch, samples, stats=None, clock=None):
        """The host stage of one rollout chunk: decode -> reward_fn ->
        retokenize and right-pad the (stop-trimmed) outputs -> clip -> the
        running-moments reward scaling. Returns (prompt_tensors,
        sample_outputs, outputs, scores, scores_mask); a seq2seq
        sample_outputs row is the decoder's, [start, output, pad...] of
        1 + max_new columns."""
        method = self.config.method
        pad_id = self.tokenizer.pad_token_id
        max_new = self._max_new()

        prompt_tensors = np.asarray(batch["input_ids"])
        n_samples = len(samples)
        str_samples, str_prompts, str_outputs = self.decode(
            prompt_tensors, samples, [prompt_tensors.shape[1]] * n_samples, append_eos_token=True
        )
        metadata = {k: v for k, v in batch.items() if k not in ("input_ids", "attention_mask")}
        score_rows = self._score_samples(str_samples, str_prompts, str_outputs, metadata)
        if stats is not None and clock is not None:
            stats["time/rollout_score"] = clock.tick()
        width = max(len(r) for r in score_rows)
        scores = np.full((n_samples, width), -np.inf, dtype=np.float32)
        for i, r in enumerate(score_rows):
            scores[i, : len(r)] = r
        scores_mask = scores != -np.inf

        outputs = [self.tokenizer.encode(o, add_special_tokens=False)[:max_new] for o in str_outputs]
        lead = 1 if self.seq2seq else 0
        sample_outputs = np.full((n_samples, lead + max_new), pad_id, dtype=np.int32)
        if self.seq2seq:
            sample_outputs[:, 0] = int(self.model_cfg.decoder_start_token_id)
        for i, o in enumerate(outputs):
            sample_outputs[i, lead: lead + len(o)] = o

        if method.cliprange_reward:
            scores = np.where(scores_mask, np.clip(scores, -method.cliprange_reward, method.cliprange_reward), scores)

        sample_scores = np.where(scores_mask, scores, 0.0).sum(axis=1)
        if self.ref_mean is None:
            self.ref_mean, self.ref_std = float(sample_scores.mean()), float(sample_scores.std())
        all_scores_mean, all_scores_std = self.running_moments.update(sample_scores)
        if stats is not None:
            stats["rollout_scores/mean"] = all_scores_mean
            stats["rollout_scores/std"] = all_scores_std
            stats["rollout_scores/running_mean"] = self.running_moments.mean
            stats["rollout_scores/running_std"] = self.running_moments.std
        if method.scale_reward == "running":
            scores = np.where(scores_mask, scores / max(self.running_moments.std, 1e-8), scores)
        elif method.scale_reward == "ref":
            scores = np.where(scores_mask, scores / max(self.ref_std, 1e-8), scores)
        return prompt_tensors, sample_outputs, outputs, scores, scores_mask

    @torch.no_grad()
    def trunk_cache_fill(self, all_tokens: torch.Tensor) -> torch.Tensor:
        """The frozen trunk (embeddings and blocks [0, split)) over a chunk
        of query|response tokens [b, t]: the activation entering the split,
        [b, t, d] in `method.trunk_cache_dtype`, on the device. One pass a
        chunk, amortized over `ppo_epochs` inner epochs of suffix-only
        steps."""
        attention_mask = (all_tokens != self.tokenizer.pad_token_id).long()
        h = self.model.forward_trunk(all_tokens, attention_mask, position_ids(attention_mask), self.split)
        return h.to(getattr(torch, self.config.method.trunk_cache_dtype))

    def _chunk_to_elements(self, prompt_tensors, sample_outputs, outputs, scores, scores_mask,
                           logprobs, values, log_ratio, h_cache=None) -> List[PPORLElement]:
        """Slice each sample's response window into a PPORLElement:
        logprobs[i] is the logprob with which all_tokens[i + 1] was drawn
        (seq2seq: the decoder's token i + 1, the window starting at 0 and
        the response keeping its start token). With the trunk cache, an
        element keeps the cache rows of exactly its query and response
        tokens (the loader re-pads them)."""
        pad_id = self.tokenizer.pad_token_id
        start = 0 if self.seq2seq else prompt_tensors.shape[1] - 1
        kl_penalty = -self._kl_coef() * log_ratio
        elements = []
        for ix in range(len(sample_outputs)):
            # an empty response keeps one (padding) slot
            if self.seq2seq:
                n_resp = max(len(outputs[ix]), 1)
                response_tensor = sample_outputs[ix, :n_resp + 1]
            else:
                n_resp = max(int((sample_outputs[ix] != pad_id).sum()), 1)
                response_tensor = sample_outputs[ix, :n_resp]
            end = start + n_resp
            rewards = kl_penalty[ix, start:end].copy()
            if scores.shape[1] == 1:
                # a scalar score lands on the final token
                rewards[-1] += scores[ix, 0]
            else:
                dense = scores[ix, : int(scores_mask[ix].sum())][: len(rewards)]
                rewards[: len(dense)] += dense
            elements.append(PPORLElement(
                query_tensor=prompt_tensors[ix],
                response_tensor=response_tensor,
                logprobs=logprobs[ix, start:end],
                values=values[ix, start:end],
                rewards=rewards,
                h_split=None if h_cache is None else h_cache[ix, : prompt_tensors.shape[1] + n_resp],
            ))
        return elements

    def _kl_coef(self) -> float:
        """The KL penalty's coefficient for the rewards built now: the
        controller's, times the sentinel's cooldown boost after a rewind
        (`train.sentinel_kl_boost`; 1.0 is off). The pipelined cycle's
        in-graph rewards read the controller's alone, as JAX's do."""
        kl_coef = self.kl_ctl.value
        if self._sentinel is not None:
            kl_coef *= self._sentinel.kl_scale(self.iter_count)
        return kl_coef

    def _quarantine_elements(self, elements, scores, scores_mask, outputs):
        """The sentinel's rollout quarantine: drop reward outliers and
        degenerate rows (length collapse, one token repeated) of one
        chunk's elements before they enter the store. Returns (kept,
        n_dropped)."""
        sample_scores = np.where(scores_mask, scores, 0.0).sum(axis=1)
        resp_lens = np.array([len(o) for o in outputs], dtype=np.int32)
        rep_fracs = np.array([repetition_frac(o) for o in outputs], dtype=np.float64)
        drop = self._sentinel.quarantine_mask(sample_scores, resp_lens, rep_fracs)
        if not drop.any():
            return elements, 0
        return [e for e, d in zip(elements, drop) if not d], int(drop.sum())

    # ------------------------------------------------------------------
    # Disaggregated rollouts: the fleet backend (train.rollout_backend)
    # ------------------------------------------------------------------

    def _fleet_rollouts_enabled(self) -> bool:
        """Whether `make_experience` generates on the rollout fleet. The
        default "local" keeps the local sampler."""
        backend = getattr(self.config.train, "rollout_backend", "local")
        if backend not in ("local", "fleet"):
            raise ValueError(f"unknown train.rollout_backend {backend!r} (want 'local' or 'fleet')")
        if backend == "fleet" and self.seq2seq:
            logger.warning_once("rollout_backend='fleet' does not support seq2seq models; generating locally")
            return False
        return backend == "fleet"

    def _router_kwargs(self) -> Dict:
        train = self.config.train
        kwargs = dict(getattr(train, "rollout_fleet_kwargs", None) or {})
        kwargs.setdefault("max_staleness_steps", getattr(train, "rollout_max_staleness_steps", 1))
        return kwargs

    def _get_rollout_router(self):
        """The ReplicaRouter over `train.rollout_fleet_urls`, built once;
        under `train.rollout_fleet_supervised` the one a FleetSupervisor
        owns, over the replicas it launches. A router tracer comes only
        from `rollout_fleet_kwargs` (`train.tracing` is not ported)."""
        if self._rollout_router is None:
            train = self.config.train
            if getattr(train, "rollout_fleet_supervised", False):
                self._rollout_router = self._start_rollout_supervisor().router
                return self._rollout_router
            from trlx_tpu_torch.inference.fleet import ReplicaRouter

            urls = list(getattr(train, "rollout_fleet_urls", None) or [])
            if not urls:
                raise ValueError("train.rollout_backend='fleet' needs train.rollout_fleet_urls")
            self._rollout_router = ReplicaRouter(urls, **self._router_kwargs())
        return self._rollout_router

    def _snapshot_params(self) -> Dict[str, torch.Tensor]:
        """One detached copy of the policy's weights, taken in the trainer's
        thread between optimizer steps: what the thread replicas decode on
        (every engine copies it into its own module)."""
        self._fleet_params = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self._fleet_params_step = self.iter_count
        return self._fleet_params

    def _start_rollout_supervisor(self):
        """Launch the trainer's own rollout fleet: `rollout_fleet_size`
        thread replicas of `serve()` (and `rollout_fleet_spares` warm
        spares) under a FleetSupervisor: a dead replica respawns with
        backoff, a crash-looping one is quarantined, and new
        manifest-complete checkpoints under `train.checkpoint_dir` roll
        through the fleet one replica at a time. Each replica swaps its
        engine onto the current snapshot of the weights as it boots, so
        none ever decodes on the trainer's own module."""
        if self._rollout_supervisor is None:
            from trlx_tpu_torch.inference.supervisor import FleetSupervisor, ThreadReplica

            train = self.config.train
            sup_kwargs = dict(getattr(train, "rollout_fleet_supervisor_kwargs", None) or {})
            watch_dir = sup_kwargs.pop("watch_dir", train.checkpoint_dir)
            self._snapshot_params()

            def factory(seat_index):
                def boot():
                    # watch_dir "" (None): the supervisor owns reloads
                    server = self.serve(host="127.0.0.1", port=0, watch_dir="", background=True)
                    # a respawn boots on the supervisor's thread: it reads
                    # the last snapshot, never the live weights
                    server.engine.set_params(self._fleet_params)
                    server.fault_injector = self.fault_injector
                    return server

                return ThreadReplica(boot)

            supervisor = FleetSupervisor(
                factory,
                num_replicas=int(getattr(train, "rollout_fleet_size", 2)),
                spares=int(getattr(train, "rollout_fleet_spares", 0)),
                router_kwargs=self._router_kwargs(),
                watch_dir=watch_dir,
                fault_injector=self.fault_injector,
                **sup_kwargs,
            )
            supervisor.start()
            if not supervisor.wait_ready(timeout_s=supervisor.start_timeout_s):
                supervisor.stop()
                raise RuntimeError(
                    f"supervised rollout fleet failed to reach full capacity within {supervisor.start_timeout_s}s"
                )
            self._rollout_supervisor = supervisor
        return self._rollout_supervisor

    def shutdown_rollout_fleet(self) -> None:
        """Tear the rollout fleet down: stop supervision, kill (and release)
        the thread replicas, close the router. A no-op without a fleet;
        `learn()` calls it on the way out."""
        supervisor, self._rollout_supervisor = self._rollout_supervisor, None
        router, self._rollout_router = self._rollout_router, None
        if supervisor is not None:
            supervisor.stop()  # kills the replicas, closes the router it owns
        elif router is not None:
            router.close()
        self._fleet_params = None

    def _push_params_to_thread_replicas(self) -> None:
        """Refresh the trainer's thread replicas with the policy's weights
        when it has stepped since the last push: one snapshot, set into
        every seat's engine (each copies it into its own module).
        Out-of-process replicas take new weights through the supervisor's
        rolling checkpoint sync. Holds the supervisor's lock, so no seat
        boots half way through."""
        sup = self._rollout_supervisor
        if sup is None or self.iter_count == self._fleet_params_step:
            return
        with sup._lock:
            params = self._snapshot_params()
            for seat in sup.seats:
                engine = getattr(getattr(seat.handle, "server", None), "engine", None)
                if engine is not None and engine.has_params:
                    engine.set_params(params)

    def _anchor_router(self, router, trainer_step: int) -> None:
        """The staleness bound: supervised replicas advance only when the
        supervisor rolls a checkpoint through, so it anchors to the last
        synced step; a fleet given by URL to the trainer's step."""
        if self._rollout_supervisor is not None:
            self._push_params_to_thread_replicas()
            router.set_trainer_step(self._rollout_supervisor.synced_step)
        else:
            router.set_trainer_step(trainer_step)

    def _fleet_generate(self, batch, gen_kwargs, trainer_step: int = 0):
        """Generate one chunk on the rollout fleet, one request a prompt
        (unpadded ids). A GRPO batch arrives expanded (G adjacent identical
        rows a prompt): only its unique prompts travel, each with `n=G`,
        which the server turns into `Scheduler.submit_n`. Returns the local
        sampler's out-dict layout (host arrays), or the local sampler's
        own when the whole fleet is down."""
        from trlx_tpu_torch.inference.fleet import FleetUnavailableError

        G = int(getattr(self.config.method, "group_size", 1))
        max_new = int(gen_kwargs.get("max_new_tokens", 40))
        input_ids = np.asarray(batch["input_ids"])
        attention_mask = np.asarray(batch["attention_mask"])
        assert input_ids.shape[0] % G == 0, "expanded batch must hold whole groups"
        prompts = [[int(t) for t, m in zip(row, mask) if m] for row, mask in zip(input_ids[::G], attention_mask[::G])]
        router = self._get_rollout_router()
        self._anchor_router(router, trainer_step)
        try:
            replies = router.generate(prompts, max_new_tokens=max_new, **({"n": G} if G > 1 else {}))
        except FleetUnavailableError as e:
            # the whole fleet is down: the chunk is generated locally (a
            # one-time warning; it counts in fleet/degraded_chunks)
            logger.warning_once(f"rollout fleet unavailable; degrading to local generation ({e})")
            return self.generate(batch["input_ids"], batch["attention_mask"], gen_kwargs)
        # the local sampler's layout: the prompt block and the response
        # columns, plus the replicas' per-token behaviour logprobs
        pad_id = self.tokenizer.pad_token_id
        n, plen = input_ids.shape
        samples = np.full((n, plen + max_new), pad_id, dtype=np.int32)
        samples[:, :plen] = input_ids
        response_tokens = np.full((n, max_new), pad_id, dtype=np.int32)
        response_mask = np.zeros((n, max_new), dtype=np.int32)
        behavior_logprobs = np.zeros((n, max_new), dtype=np.float32)
        for p, rep in enumerate(replies):
            seqs = rep.get("sequences") or [rep]
            for g in range(G):
                i, seq = p * G + g, seqs[min(g, len(seqs) - 1)]
                toks = list(seq["token_ids"])[:max_new]
                lps = list(seq.get("token_logprobs") or [])[: len(toks)]
                samples[i, plen:plen + len(toks)] = toks
                response_tokens[i, : len(toks)] = toks
                response_mask[i, : len(toks)] = 1
                behavior_logprobs[i, : len(lps)] = lps
        return {"samples": samples, "response_tokens": response_tokens, "response_mask": response_mask,
                "behavior_logprobs": behavior_logprobs, "fleet": True}

    def _apply_behavior_logprobs(self, logprobs, out, prompt_tensors, sample_outputs) -> int:
        """Overwrite the scorer's policy logprobs with the replicas' (the
        behaviour policy's, which the importance ratio wants) on the rows
        whose retokenized response equals the raw sampled tokens; other
        rows keep the scorer's. Returns the rows overwritten; `logprobs`
        changes in place."""
        pad_id = self.tokenizer.pad_token_id
        raw_tokens, raw_mask = np.asarray(out["response_tokens"]), np.asarray(out["response_mask"])
        behavior = np.asarray(out["behavior_logprobs"])
        start = prompt_tensors.shape[1] - 1
        hits = 0
        for ix in range(len(sample_outputs)):
            n_resp = int((sample_outputs[ix] != pad_id).sum())
            if n_resp == 0 or n_resp != int(raw_mask[ix].sum()):
                continue
            if not np.array_equal(sample_outputs[ix, :n_resp], raw_tokens[ix, :n_resp]):
                continue
            logprobs[ix, start:start + n_resp] = behavior[ix, :n_resp]
            hits += 1
        return hits

    def _fleet_stats(self, supervisor: bool = True) -> Dict[str, float]:
        """The router's lifetime counters (and the supervisor's lifecycle
        ones) as `fleet/*` stats."""
        stats = {}
        sources = [self._rollout_router] + ([self._rollout_supervisor] if supervisor else [])
        for source in sources:
            if source is None:
                continue
            for k, v in source.stats().items():
                if isinstance(v, (int, float)):
                    stats[f"fleet/{k}"] = float(v)
        return stats

    # ------------------------------------------------------------------
    # Multi-turn experience (environments over fleet sessions)
    # ------------------------------------------------------------------

    def _multiturn_group_size(self) -> int:
        """Episodes a shared environment seed: 1 for PPO; GRPO's G."""
        return 1

    def _run_episode(self, router, env, seed, max_new, max_turns):
        """One conversation: policy turns through one fleet chat session
        (its replica keeps the conversation's KV between turns, so each
        turn after the first prefills only its new tokens) alternating
        with the environment's replies. Returns (prompt_ids, segments,
        retained_hits); a segment is (kind, ids, logprobs, reward), kind
        "policy" or "env", the reward belonging to its policy turn."""
        tok = self.tokenizer
        obs = env.reset(seed)
        prompt_ids = [int(t) for t in tok.encode(obs)]
        key = f"mt-{uuid.uuid4().hex[:12]}"
        segments = []
        retained_hits = 0
        turn_ids = prompt_ids
        try:
            for t in range(max_turns):
                out = router.chat(turn_ids, session_key=key, max_new_tokens=max_new)
                resp_ids = [int(x) for x in out["token_ids"]]
                retained_hits += int(bool(out.get("retained_hit")))
                text = out.get("text")
                if text is None:
                    text = tok.decode(resp_ids)
                step_out = env.step(text)
                lps = [float(x) for x in (out.get("token_logprobs") or [])]
                segments.append(("policy", resp_ids, lps[: len(resp_ids)], float(step_out.reward)))
                if step_out.done or t == max_turns - 1:
                    break
                env_ids = [int(x) for x in tok.encode(step_out.text)]
                if not env_ids:
                    # /chat needs a non-empty turn: a silent environment
                    # still hands the floor back to the policy
                    env_ids = [int(x) for x in tok.encode(" ")]
                segments.append(("env", env_ids, None, 0.0))
                turn_ids = env_ids
        finally:
            router.end_session(key)
        return prompt_ids, segments, retained_hits

    def make_experience_multiturn(self, num_rollouts: int = 1024, iter_count: int = 0):
        """Collect multi-turn rollouts (`method.multiturn_env`): whole
        environment episodes through fleet chat sessions, 8 at a time. An
        episode is one rollout element whose response is every turn after
        the opening observation; the environment's raw turn rewards are
        used as they are (`scale_reward` does not apply)."""
        from trlx_tpu_torch.environments import make_environment

        logger.info("Collecting multi-turn rollouts")
        if self.seq2seq:
            raise NotImplementedError("multi-turn rollouts are causal-only")
        if not self._fleet_rollouts_enabled():
            raise ValueError(
                "method.multiturn_env requires train.rollout_backend='fleet' (episodes run through fleet chat "
                "sessions)"
            )
        method = self.config.method
        env_kwargs = dict(getattr(method, "multiturn_env_kwargs", None) or {})
        max_turns = max(int(getattr(method, "multiturn_max_turns", 4)), 1)
        max_new = self._max_new()
        G = max(self._multiturn_group_size(), 1)
        router = self._get_rollout_router()
        self._anchor_router(router, iter_count)

        elements: List[PPORLElement] = []
        accumulated: List[Dict] = []
        seed0 = int(self._mt_seed_offset)
        chunk_size = max(int(method.chunk_size), 1)
        clock = Clock()
        while len(elements) < num_rollouts:
            if self._watchdog is not None:
                self._watchdog.beat()
            n_chunk = min(chunk_size, num_rollouts - len(elements))
            n_chunk = max((n_chunk + G - 1) // G * G, G)  # whole groups
            clock.tick()

            def one(i, seed0=seed0):
                env = make_environment(method.multiturn_env, **env_kwargs)
                # same-seed groups: episodes with equal i // G play the same
                # task and differ only by sampling
                return self._run_episode(router, env, seed0 + i // G, max_new, max_turns)

            with ThreadPoolExecutor(max_workers=min(n_chunk, 8)) as pool:
                episodes = list(pool.map(one, range(n_chunk)))
            seed0 += n_chunk // G
            stats: Dict[str, float] = {"time/rollout_generate": clock.tick()}
            elements.extend(self._episodes_to_elements(episodes, stats))
            stats["time/rollout_time"] = clock.tick()
            accumulated.append(stats)
            logger.info(f"[multi-turn rollout {len(elements)} / {num_rollouts}]")
        self._mt_seed_offset = seed0
        stats = {k: sum(x[k] for x in accumulated) / len(accumulated) for k in accumulated[-1]}
        stats["kl_ctl_value"] = self.kl_ctl.value
        stats.update(self._fleet_stats(supervisor=False))
        self.mean_kl = stats["policy/sqrt_kl"] ** 2
        self.tracker.log(stats, step=iter_count)
        self.push_to_store(elements)

    def _episodes_to_elements(self, episodes, stats):
        """Pad one chunk of episodes into a batch, score it, splice the
        replicas' behaviour logprobs onto the policy tokens, and hand over
        to `_multiturn_elements` (PPO's per-token rewards; GRPO's group
        advantages)."""
        pad_id = self.tokenizer.pad_token_id
        n = len(episodes)
        max_q = max(len(p) for p, _, _ in episodes)
        rows = []
        for prompt_ids, segments, hits in episodes:
            ids: List[int] = []
            lmask: List[float] = []
            erew: List[float] = []
            blps: List[Optional[float]] = []
            for kind, seg_ids, lps, reward in segments:
                pol = kind == "policy"
                ids.extend(seg_ids)
                lmask.extend([1.0 if pol else 0.0] * len(seg_ids))
                erew.extend([0.0] * len(seg_ids))
                if pol and seg_ids:
                    erew[-1] = float(reward)  # the turn's reward on its last token
                if pol:
                    blps.extend(list(lps) + [None] * (len(seg_ids) - len(lps)))
                else:
                    blps.extend([None] * len(seg_ids))
            if not ids:  # a degenerate episode (an empty first reply)
                ids, lmask, erew, blps = [pad_id], [0.0], [0.0], [None]
            rows.append((prompt_ids, ids, lmask, erew, blps, hits))
        # the scored width is capped at the train context: a conversation
        # past it loses its tail tokens (and any reward on them)
        cap = max(int(self.config.train.seq_length) - max_q, 1)
        max_r = min(max(len(r[1]) for r in rows), cap)

        prompt_tensors = np.full((n, max_q), pad_id, np.int32)
        sample_outputs = np.full((n, max_r), pad_id, np.int32)
        loss_mask = np.zeros((n, max_r), np.float32)
        env_rewards = np.zeros((n, max_r), np.float32)
        left = self.tokenizer.padding_side == "left"
        for i, (p, ids, lm, er, _bl, _h) in enumerate(rows):
            w = min(len(ids), max_r)
            if left:
                prompt_tensors[i, max_q - len(p):] = p
            else:
                prompt_tensors[i, : len(p)] = p
            sample_outputs[i, :w] = ids[:w]
            loss_mask[i, :w] = lm[:w]
            env_rewards[i, :w] = er[:w]

        all_tokens = torch.from_numpy(np.concatenate([prompt_tensors, sample_outputs], axis=1)).to(self.device).long()
        scored = self.score(all_tokens)
        logprobs, values, log_ratio = (x.cpu().numpy() for x in scored[:3])
        mean_kl, mean_kl_per_token = float(scored[3]), float(scored[4])
        start = max_q - 1
        # the replica's sampler is the behaviour policy: its logprob for
        # response token j (all_tokens column max_q + j) lands at scorer
        # column start + j
        for i, (_p, _ids, _lm, _er, bl, _h) in enumerate(rows):
            for j, lp in enumerate(bl[:max_r]):
                if lp is not None:
                    logprobs[i, start + j] = lp
        stats["policy/sqrt_kl"] = float(np.sqrt(max(mean_kl, 0.0)))
        stats["policy/kl_per_token"] = float(np.sqrt(max(mean_kl_per_token, 0.0)))
        stats["rollout/mean_env_reward"] = float(env_rewards.sum(1).mean())
        stats["rollout/mean_turns"] = float(np.mean([sum(1 for s in segs if s[0] == "policy")
                                                     for _, segs, _ in episodes]))
        stats["rollout/retained_hit_turns"] = float(sum(r[5] for r in rows))
        return self._multiturn_elements(rows, prompt_tensors, sample_outputs, loss_mask, env_rewards, logprobs,
                                        values, log_ratio, start, max_r)

    def _multiturn_elements(self, rows, prompt_tensors, sample_outputs, loss_mask, env_rewards, logprobs,
                            values, log_ratio, start, max_r):
        """PPO rewards for a multi-turn chunk: the per-token KL penalty on
        policy tokens only, plus each turn's reward on its last token; GAE
        runs over the whole response and the loss mask keeps the
        environment's tokens out of the objective."""
        kl_coef = self._kl_coef()
        elements = []
        for i, (_p, ids, _lm, _er, _bl, _h) in enumerate(rows):
            n_resp = max(min(len(ids), max_r), 1)
            end = start + n_resp
            lmask_row = np.asarray(loss_mask[i, :n_resp], np.float32)
            rewards = (-kl_coef * log_ratio[i, start:end]) * lmask_row
            rewards = rewards.astype(np.float32) + env_rewards[i, :n_resp]
            elements.append(PPORLElement(
                query_tensor=prompt_tensors[i],
                response_tensor=sample_outputs[i, :n_resp],
                logprobs=logprobs[i, start:end],
                values=values[i, start:end],
                rewards=rewards,
                loss_mask=lmask_row.copy(),
            ))
        return elements

    # ------------------------------------------------------------------
    # Self-speculative decode, the int8 decode view, the trunk cache
    # ------------------------------------------------------------------

    def _spec_decode_available(self) -> bool:
        """Whether sampling may run the draft/verify sampler: the JAX gate.
        It needs a real hydra split (the frozen trunk is the draft model),
        no MoE (the router recomputes per-token state the rollback cannot
        unwind), no prompt or prefix tokens, one beam and no repetition
        penalty (its seen set cannot be rolled back), and a causal LM. A
        refusal while the flag is on counts in `spec_decode_fallbacks`."""
        if not getattr(self.config.method, "speculative_decode", False):
            return False
        gen_kwargs = self.generate_experience_kwargs or self.generate_kwargs
        ok = (
            not self.seq2seq
            and self.split > 0
            and self.model_cfg.moe_experts == 0
            and self.model_cfg.prompt_tokens == 0
            and self.model_cfg.prefix_tokens == 0
            and int(gen_kwargs.get("num_beams", 1) or 1) == 1
            and float(gen_kwargs.get("repetition_penalty", 1.0) or 1.0) == 1.0
        )
        if not ok:
            self.spec_decode_fallbacks += 1
        return ok

    def _spec_k_effective(self) -> int:
        return int(self.config.method.spec_k) if self._spec_decode_available() else 0

    def _accum_spec_stats(self, out, stats: Optional[Dict] = None):
        """Fold a sampling dict's speculative counters into the running
        totals and, when given, a chunk's stats (read after the samples, so
        no extra wait on the device)."""
        if "spec_rounds" not in out:
            return
        rounds = int(out["spec_rounds"].sum())
        accepted = int(out["spec_accepted"].sum())
        self.spec_decode_rounds += rounds
        self.spec_decode_accepted += accepted
        if stats is not None and rounds > 0:
            k = int(self.config.method.spec_k)
            stats["rollout/spec_accept_rate"] = accepted / float(k * rounds)
            stats["rollout/spec_tokens_per_round"] = 1.0 + accepted / float(rounds)

    def _spec_draft_head(self):
        """The rank-`spec_draft_rank` SVD of the dense unembedding, computed
        once on the host. The tied embedding is frozen under any split, so
        the factors never go stale; an untied head drifts, which costs
        acceptance only (the correction keeps the output exact)."""
        if self._spec_draft_head_cache is None:
            from trlx_tpu_torch.ops.sampling import spec_draft_head_from_params

            self._spec_draft_head_cache = spec_draft_head_from_params(
                self.model.state_dict(), self.model_cfg, int(self.config.method.spec_draft_rank))
        return self._spec_draft_head_cache

    def _decode_params(self):
        """The sampler's view under `method.quantize_frozen_trunk`: the
        frozen trunk's int8 leaves, quantized once (they never train); the
        sampler reads every other parameter live. None (the dense module)
        otherwise."""
        if not (getattr(self.config.method, "quantize_frozen_trunk", False) and self.split > 0
                and not self.seq2seq):
            return None
        if self._quant_frozen is None:
            self._quant_frozen = quant.quantize_frozen(self.model, self.split)
        return self._quant_frozen

    def _trunk_cache_available(self) -> bool:
        """Whether steps may resume from cached trunk activations: the flag,
        a real hydra split (blocks [0, split) entirely frozen, so the cache
        cannot go stale within a collection), no MoE (the load-balancing
        term comes from the full forward), a value branch tapping at or
        above the split (its input must be derivable from the cache) and a
        causal LM (an encoder-decoder's split has no single trunk
        activation)."""
        method = self.config.method
        return (
            bool(getattr(method, "cache_trunk_activations", False))
            and not self.seq2seq
            and self.split > 0
            and self.model_cfg.moe_experts == 0
            and self.model_cfg.n_layers - getattr(method, "num_value_layers_unfrozen", 0) >= self.split
        )

    # ------------------------------------------------------------------
    # The pipelined cycle: one blocking host fetch a PPO iteration
    # ------------------------------------------------------------------

    def _spec_path_available(self) -> bool:
        """Whether the speculative rollout scorer may run. The device's
        retokenization must be able to equal the host round trip: an
        id-local tokenizer (`_n_plain_ids`) and no stop sequences (those
        trim by string). Dense rewards turn it off once a chunk shows them:
        its merge is scalar-only, so its forward would only double the
        scoring. Seq2seq has none (the host retokenization is not id-local
        there)."""
        return (
            not self.seq2seq
            and not self.stop_sequences
            and not self._spec_disabled_dense
            and getattr(self.tokenizer, "_n_plain_ids", None) is not None
        )

    def _fast_rollout_available(self) -> bool:
        """Whether the rollout fast path (`method.capture_rollout_stats`)
        runs: everything the speculative scorer needs (the host
        retokenization stays the arbiter), a real hydra split (the
        reference's suffix is what is left after the capture), values from
        the plain value head (no deeper value branch) and one beam (the
        sampler is where the capture lives)."""
        method = self.config.method
        if not getattr(method, "capture_rollout_stats", False):
            return False
        gen_kwargs = self.generate_experience_kwargs or self.generate_kwargs
        return (
            self._spec_path_available()
            and self.split > 0
            and getattr(method, "num_value_layers_unfrozen", 0) == 0
            and int(gen_kwargs.get("num_beams", 1) or 1) == 1
        )

    def _max_new(self) -> int:
        return int((self.generate_experience_kwargs or self.generate_kwargs).get("max_new_tokens", 40))

    def dispatch_rollout_generation(self):
        """Sample the next chunk of prompts on the current parameters,
        capturing the fast path's stats where it runs. Returns (the prompt
        batch, the sampler's dict of device tensors). Eager torch runs the
        whole sampling loop here (one host sync a step) where the JAX
        trainer only enqueues it."""
        batch = self._next_prompts()
        out = self.generate(batch["input_ids"], batch["attention_mask"],
                            self.generate_experience_kwargs or self.generate_kwargs,
                            capture=self._fast_rollout_available(), spec_k=self._spec_k_effective())
        return batch, out

    def _spec_merge(self, prompt_tensors, responses, lp_win, v_win, logratio_win, scores_eff, kl_coef: float,
                    scalar: bool, response_tensors=None) -> PPORLBatch:
        """Per-token rewards on the device from the scored response windows
        and the host scores (the JAX `_build_spec_merge_fn`, whose formulas
        the classic scorer shares): the KL penalty on each real response
        token (an empty response keeps one slot), plus a scalar score on
        the last of them or a dense score on each. A PPORLBatch of device
        tensors, stats zero past each response; its responses are
        `response_tensors` when given (seq2seq: the decoder's rows, whose
        start token `responses` leaves out)."""
        r = responses.shape[1]
        j = torch.arange(r, device=responses.device)[None, :]
        n_resp = (responses != self.tokenizer.pad_token_id).sum(1, keepdim=True).clamp(min=1)
        valid = (j < n_resp).float()
        rewards = (-float(np.float32(kl_coef))) * logratio_win * valid
        if scalar:
            rewards = rewards + (j == n_resp - 1) * scores_eff[:, :1]
        else:
            rewards = rewards + scores_eff * valid
        return PPORLBatch(query_tensors=prompt_tensors,
                          response_tensors=responses if response_tensors is None else response_tensors,
                          logprobs=lp_win * valid, values=v_win * valid, rewards=rewards)

    @torch.no_grad()
    def _score_reward(self, prompt_tensors, sample_outputs, scores_eff, kl_coef: float, scalar: bool):
        """The hydra score of query|response and the per-token rewards, all
        on the device (the JAX `_build_score_reward_fn`, mirroring
        `_chunk_to_elements`): the pipelined cycle's classic scorer and the
        speculative one's fallback; for seq2seq the JAX `score_reward_s2s`,
        decoder-relative. Returns (PPORLBatch of device tensors, mean_kl,
        mean_kl_per_token), the last two 0-d tensors."""
        if self.seq2seq:
            logprobs, values, log_ratio, mean_kl, mean_kl_per_token = self.score_seq2seq(prompt_tensors,
                                                                                        sample_outputs)
            chunk = self._spec_merge(prompt_tensors, sample_outputs[:, 1:], logprobs, values, log_ratio, scores_eff,
                                     kl_coef, scalar, response_tensors=sample_outputs)
            return chunk, mean_kl, mean_kl_per_token
        logprobs, values, log_ratio, mean_kl, mean_kl_per_token = self.score(
            torch.cat([prompt_tensors, sample_outputs], dim=1))
        start, r = prompt_tensors.shape[1] - 1, sample_outputs.shape[1]
        win = lambda x: x[:, start:start + r]
        chunk = self._spec_merge(prompt_tensors, sample_outputs, win(logprobs), win(values), win(log_ratio),
                                 scores_eff, kl_coef, scalar)
        return chunk, mean_kl, mean_kl_per_token

    @torch.no_grad()
    def _spec_fwd(self, samples, trimmed, q: int, max_new: int):
        """The speculative half of `_score_reward` (the JAX
        `_build_spec_fwd_fn`): the hydra score of the prompts and the
        device-trimmed responses, before the host has retokenized them.
        Returns the response windows of (logprobs, values, log-ratio) and
        mean_kl."""
        logprobs, values, log_ratio, mean_kl, _ = self.score(torch.cat([samples[:, :q], trimmed], dim=1))
        win = lambda x: x[:, q - 1:q - 1 + max_new]
        return win(logprobs), win(values), win(log_ratio), mean_kl

    def _dispatch_spec_score(self, out):
        """The speculative scorer over a sampling dict: (trimmed, lp_win,
        v_win, logratio_win, mean_kl), device tensors; `trimmed` is the
        device's retokenization of the raw responses (the JAX
        `_build_spec_trim_fn`)."""
        samples, max_new = out["samples"], self._max_new()
        q = samples.shape[1] - out["response_tokens"].shape[1]
        trimmed = self.tokenizer.device_retokenize(samples[:, q:], max_new)
        return (trimmed, *self._spec_fwd(samples, trimmed, q, max_new))

    @torch.no_grad()
    def _fast_fwd(self, samples, h_split, lp_cap, v_cap, q: int, max_new: int):
        """The fast path's score (the JAX `_build_fast_fwd_fn`): the
        sampler captured the policy's logprobs and values and the
        activations entering the split, so only the reference's suffix
        runs, its head over the response window alone. Window semantics
        are `_spec_fwd`'s, with one documented divergence: mean_kl sums
        over the window's real labels only, where the classic sum also
        counts prompt positions (zero there) and the pad label after an
        early eos. It feeds only the KL controller and logs; the loss's
        ratios are the same."""
        pad_id = self.tokenizer.pad_token_id
        attention_mask = (samples != pad_id).long()
        ref_logits_w = self.ref_model.forward_suffix_window(h_split, attention_mask, position_ids(attention_mask),
                                                            q - 1, max_new)
        labels = samples[:, q:q + max_new]
        ref_lp = logprobs_of_labels(ref_logits_w, labels)
        log_ratio_w = (lp_cap - ref_lp) * (labels != pad_id).float()
        kl = torch.exp(log_ratio_w) - 1 - log_ratio_w
        return lp_cap, v_cap, log_ratio_w, kl.sum(1).mean()

    def _dispatch_fast_score(self, out):
        """The fast path's analogue of `_dispatch_spec_score`, with its
        5-tuple, so the cycle's arbitration and merge are shared: the trim
        still goes to the host's arbitration. Under the trunk cache the
        captured activations ride on `out["trunk_cache"]`, for the cycle to
        attach once the arbitration confirms raw == retokenized."""
        samples, max_new = out["samples"], self._max_new()
        q = samples.shape[1] - out["response_tokens"].shape[1]
        trimmed = self.tokenizer.device_retokenize(samples[:, q:], max_new)
        scored = self._fast_fwd(samples, out["h_split"], out["logprobs"], out["values"], q, max_new)
        if self._trunk_cache_available():
            out["trunk_cache"] = out["h_split"]
        return (trimmed, *scored)

    def _attach_trunk_cache(self, chunk: PPORLBatch, captured: Optional[torch.Tensor] = None) -> PPORLBatch:
        """The trunk cache of a device chunk, when the gate is on: the
        sampler's captured activations, cast to `trunk_cache_dtype`, where
        their width is the chunk's query + response (a fast-path hit
        guarantees it); else one trunk pass (`trunk_cache_fill`). Under the
        int8 decode view the captured rows come from the dequantized trunk,
        as in JAX."""
        if not self._trunk_cache_available():
            return chunk
        if captured is not None and captured.shape[1] == chunk.query_tensors.shape[1] + chunk.response_tensors.shape[1]:
            h = captured.to(getattr(torch, self.config.method.trunk_cache_dtype))
        else:
            h = self.trunk_cache_fill(torch.cat([chunk.query_tensors, chunk.response_tensors], dim=1))
        return dataclasses.replace(chunk, h_split=h)

    def train_epochs_from_chunk(self, chunk: PPORLBatch, n_epochs: int) -> Dict[str, torch.Tensor]:
        """Every inner epoch's optimizer steps from a chunk on the device:
        the epochs' shuffles are the JAX trainer's host permutations
        (`np.random.default_rng(train.seed + iter_count)`), each batch is
        gathered on the device by an index tensor, and each step is
        `optimizer_step`'s, with no host fetch. Returns the mean of each
        stat over the steps, as device tensors; `iter_count` advances by
        the steps taken."""
        n = int(chunk.query_tensors.shape[0])
        bs = self.config.train.batch_size
        if n % bs != 0:
            raise ValueError(f"chunk of {n} rollouts not divisible by batch_size {bs}")
        steps = n // bs
        rng = np.random.default_rng(self.config.train.seed + self.iter_count)
        idx = np.concatenate([rng.permutation(n) for _ in range(n_epochs)]).reshape(n_epochs * steps, bs)
        fields = {f.name: getattr(chunk, f.name) for f in dataclasses.fields(chunk)}
        step_stats = []
        for rows in torch.from_numpy(idx).to(self.device):
            batch = PPORLBatch(**{k: None if v is None else v.index_select(0, rows) for k, v in fields.items()})
            step_stats.append(self.optimizer_step([batch])[0])
        self.iter_count += n_epochs * steps
        return {k: torch.stack([s[k] for s in step_stats]).mean() for k in step_stats[0]}

    def _fetch(self, tensors: List[torch.Tensor]) -> List[np.ndarray]:
        """The cycle's blocking device-to-host fetch; its wait goes into
        `cycle_stats`."""
        t0 = time.perf_counter()
        host = [t.cpu().numpy() for t in tensors]
        self.cycle_stats["fetch_wait_ms"] = self.cycle_stats.get("fetch_wait_ms", 0.0) + (time.perf_counter() - t0) * 1e3
        return host

    def pipelined_cycle(self, pending=None):
        """One PPO iteration (the chunks' rollouts, their scoring, every
        inner epoch, and the next chunks' rollouts) with one blocking host
        fetch: this cycle's samples (and speculative trims) with, on the
        classic and speculative schedules, the previous cycle's loss and
        mean KL. The KL controller then updates `ppo_epochs` times, the
        classic cadence of once an inner epoch.

        Where `_spec_path_available`, the hydra score runs speculatively on
        the device's retokenization; the host's arbitrates (an exact match
        of trims, prompts and, under the fast path, raw responses), and a
        miss falls back to `_score_reward`, counted in `spec_fallbacks`.
        Under the fast path the sampler captured the policy's stats, the
        score is the reference's suffix, and the next cycle's rollouts are
        sampled before this cycle's training: on one-step-stale parameters,
        whose captured logprobs are the behaviour policy's, as the PPO
        ratio needs. The loss and KL then come in a second fetch, after the
        host work.

        num_rollouts = k * chunk_size: k chunks sampled on the same
        parameters, trained on together. Returns (the previous cycle's
        loss or None, pending); pass `pending` back in, and read the last
        cycle's loss from pending[2][0]. The rollout store and logging are
        `make_experience`'s and `learn`'s, not this cycle's."""
        method = self.config.method
        if method.num_rollouts % method.chunk_size != 0:
            raise NotImplementedError(
                f"pipelined_cycle requires num_rollouts to be a multiple of chunk_size (got "
                f"{method.num_rollouts} vs {method.chunk_size}); use make_experience + learn for ragged collections"
            )
        if self._fleet_rollouts_enabled():
            logger.warning_once(
                "rollout_backend='fleet' applies to make_experience only; pipelined_cycle keeps generating "
                "locally (its schedule keeps the rollouts on the device from sampling through training)"
            )
        k = method.num_rollouts // method.chunk_size
        max_new = self._max_new()
        self.cycle_stats = {"fetch_wait_ms": 0.0, "host_ms": 0.0}

        def dispatch_chunks():
            # the gates are read at every dispatch: once dense rewards turn
            # the speculative scorer off, no more of its forwards run
            fast_ok = self._fast_rollout_available()
            spec_ok = fast_ok or self._spec_path_available()
            gens = [self.dispatch_rollout_generation() for _ in range(k)]
            if fast_ok:
                specs = [self._dispatch_fast_score(o) for _, o in gens]
            elif spec_ok:
                specs = [self._dispatch_spec_score(o) for _, o in gens]
            else:
                specs = [None] * k
            self._pending_fast = fast_ok  # which scorer the pending chunks had
            return gens, specs

        if pending is None:
            pending = (*dispatch_chunks(), None)
        gens, specs, prev = pending
        use_spec = specs[0] is not None
        use_fast = use_spec and self._pending_fast

        fetch = [o["samples"] for _, o in gens]
        if use_spec:
            fetch += [s[0] for s in specs]
        if prev is not None and not use_fast:
            fetch += list(prev)
        fetched = self._fetch(fetch)
        samples_list = fetched[:k]
        trimmed_list = fetched[k:2 * k] if use_spec else [None] * k
        for _, o in gens:
            self._accum_spec_stats(o)

        def host_stage(batch, samples):
            t0 = time.perf_counter()
            result = self._host_process_chunk(batch, samples)
            self.cycle_stats["host_ms"] += (time.perf_counter() - t0) * 1e3
            return result

        def kl_update(loss, kl):
            self.mean_kl = float(kl)
            for _ in range(method.ppo_epochs):
                self.kl_ctl.update(self.mean_kl, n_steps=self.config.train.batch_size)
            return float(loss)

        processed = None
        prev_loss = None
        if use_fast:
            # the host work first, then the previous training's handles
            processed = [host_stage(batch, samples) for (batch, _), samples in zip(gens, samples_list)]
            if prev is not None:
                prev_loss = kl_update(*self._fetch(list(prev)))
        elif prev is not None:
            prev_loss = kl_update(fetched[-2], fetched[-1])

        chunks, kl_handles = [], []
        for ci, ((batch, out), spec, samples, spec_trimmed) in enumerate(zip(gens, specs, samples_list,
                                                                             trimmed_list)):
            if processed is not None:
                prompt_tensors, sample_outputs, _, scores, scores_mask = processed[ci]
            else:
                prompt_tensors, sample_outputs, _, scores, scores_mask = host_stage(batch, samples)
            scalar = scores.shape[1] == 1
            if scalar:
                scores_eff = np.where(scores_mask, scores, 0.0).astype(np.float32)
            else:
                scores_eff = np.zeros((len(sample_outputs), max_new), np.float32)
                w = min(scores.shape[1], max_new)
                scores_eff[:, :w] = np.where(scores_mask, scores, 0.0)[:, :w]
                # reward density is the reward_fn's: no more speculative
                # forwards from the next dispatch on
                self._spec_disabled_dense = True
            q = prompt_tensors.shape[1]
            spec_hit = (
                spec is not None
                and scalar
                and spec_trimmed.shape == sample_outputs.shape
                and np.array_equal(spec_trimmed, sample_outputs)
                and np.array_equal(np.asarray(batch["input_ids"]), samples[:, :q])
                # the captured stats index the raw response tokens
                and (not use_fast or np.array_equal(samples[:, q:], sample_outputs))
            )
            to_device = lambda a: torch.from_numpy(np.asarray(a)).to(self.device)
            prompts_d, outputs_d = to_device(prompt_tensors).long(), to_device(sample_outputs).long()
            if spec_hit:
                _, lp_win, v_win, logratio_win, mean_kl = spec
                chunk = self._spec_merge(prompts_d, outputs_d, lp_win, v_win, logratio_win, to_device(scores_eff),
                                         self.kl_ctl.value, scalar)
            else:
                if spec is not None and scalar:
                    # a real arbitration miss, not the chunk that showed dense rewards
                    self.spec_fallbacks += 1
                chunk, mean_kl, _ = self._score_reward(prompts_d, outputs_d, to_device(scores_eff),
                                                       self.kl_ctl.value, scalar)
            chunks.append(self._attach_trunk_cache(chunk, captured=out.get("trunk_cache") if spec_hit else None))
            kl_handles.append(mean_kl)

        if k == 1:
            full, mean_kl = chunks[0], kl_handles[0]
        else:
            full = PPORLBatch(**{
                f.name: None if getattr(chunks[0], f.name) is None
                else torch.cat([getattr(c, f.name) for c in chunks], dim=0)
                for f in dataclasses.fields(PPORLBatch)
            })
            mean_kl = torch.stack(kl_handles).mean()

        if self._fast_rollout_available():
            # one rollout ahead: the next cycle samples on the parameters
            # before this cycle's training
            nxt = dispatch_chunks()
            stats = self.train_epochs_from_chunk(full, method.ppo_epochs)
        else:
            stats = self.train_epochs_from_chunk(full, method.ppo_epochs)
            nxt = dispatch_chunks()
        return prev_loss, (*nxt, (stats["losses/total_loss"], mean_kl))

    # ------------------------------------------------------------------
    # Loop wiring
    # ------------------------------------------------------------------

    def add_prompt_pipeline(self, pipeline):
        """Rollout prompts: chunks of `chunk_size`, reshuffled every pass."""
        self.prompt_pipeline = pipeline
        self.prompt_iterator = infinite_dataloader(pipeline.create_loader(self.config.method.chunk_size, shuffle=True))
        self._prompt_draws = 0

    def _next_prompts(self):
        self._prompt_draws += 1
        return next(self.prompt_iterator)

    def post_backward_callback(self):
        self.kl_ctl.update(self.mean_kl, n_steps=self.config.train.batch_size)

    def post_epoch_callback(self):
        if self.log_rollouts:
            self.store.export_history(location=self.rollout_logging_dir)
        self.store.clear_history()
        self.make_experience(self.config.method.num_rollouts, self.iter_count)

    def _post_rewind(self):
        """After a sentinel rewind the restored store is the one whose
        successors bred the anomaly: drop it and collect fresh experience
        under the moved generator and the cooldown. A supervised fleet's
        thread replicas get a snapshot of the restored weights before they
        decode again (the step-keyed refresh alone could take the rewound
        step for one already pushed)."""
        self.store.clear_history()
        self._fleet_params_step = None
        self.make_experience(self.config.method.num_rollouts, self.iter_count)

    def create_train_dataloader(self, seed_offset: int = 0, drop_last: bool = False):
        """A loader over the store, reshuffled per inner epoch. The query
        width is the store's longest query rounded up to a 64-token bucket
        (capped by the prompt budget), the response and stat widths the
        experience budget (a seq2seq response one column more, its start
        token), so batch shapes stay the same across collections."""
        exp_kwargs = self.generate_experience_kwargs or self.generate_kwargs
        exp_max_new = int(exp_kwargs.get("max_new_tokens", 40))
        eval_max_new = int(self.generate_kwargs.get("max_new_tokens", 40))
        budget_q = self.config.train.seq_length - eval_max_new
        obs_q = max((len(e.query_tensor) for e in self.store.history), default=0)
        bucket_q = min(budget_q, -(-obs_q // 64) * 64)
        return self.store.create_loader(
            self.config.train.batch_size, shuffle=True, drop_last=drop_last,
            seed=self.config.train.seed + self.iter_count + seed_offset,
            max_query_len=bucket_q, max_response_len=exp_max_new + (1 if self.seq2seq else 0),
            max_stat_len=exp_max_new,
        )

    def prepare_learning(self):
        self.eval_dataloader = self.eval_pipeline.create_loader(self.config.method.chunk_size)
        if self._resumed and len(self.store) > 0:
            # exact resume: the checkpoint restored the rollout store
            logger.info(f"Resume: reusing the restored rollout store ({len(self.store)} rollouts)")
        else:
            self.make_experience(self.config.method.num_rollouts)
        self.train_dataloader = self.create_train_dataloader()
        self.n_inner_epochs = self.config.method.ppo_epochs
        self.total_steps = self.config.train.epochs * self.n_inner_epochs * len(self.train_dataloader)
        self.total_steps = min(self.total_steps, self.config.train.total_steps)

    def _extra_resume_state(self):
        """The host state of an exact resume: the rollout store (with its
        trunk cache rows, when on), the KL controller and mean KL, the
        reward statistics, the frozen reference, how many prompt chunks
        were drawn and the speculative draft head (an untied head moves in
        training, so it is not recomputed)."""
        return {
            **super()._extra_resume_state(),
            "spec_draft_head": self._spec_draft_head_cache,
            "store_history": list(self.store.history),
            "kl_ctl_value": float(self.kl_ctl.value),
            "mean_kl": float(self.mean_kl),
            "running_moments": {k: getattr(self.running_moments, k) for k in ("mean", "std", "var", "count")},
            "ref_mean": self.ref_mean,
            "ref_std": self.ref_std,
            "ref_model": self.ref_model.state_dict(),
            "prompt_draws": self._prompt_draws,
        }

    def _load_extra_resume_state(self, state):
        super()._load_extra_resume_state(state)
        self.store.clear_history()
        self.store.push(state["store_history"])
        self.kl_ctl.value = state["kl_ctl_value"]
        self.mean_kl = state["mean_kl"]
        for k, v in state["running_moments"].items():
            setattr(self.running_moments, k, v)
        self.ref_mean, self.ref_std = state["ref_mean"], state["ref_std"]
        self.ref_model.load_state_dict(state["ref_model"])
        self._spec_draft_head_cache = state.get("spec_draft_head")
        self._quant_frozen = None  # rebuilt from the loaded frozen weights
        if self.prompt_pipeline is not None:
            # a fresh prompt loader replays its shuffles; skip the chunks
            # the saved run already drew
            self.add_prompt_pipeline(self.prompt_pipeline)
            for _ in range(state["prompt_draws"]):
                self._next_prompts()
