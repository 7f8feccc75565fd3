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
is absent here. Refused at construction, naming their ROADMAP items:
multi-turn rollouts and the rollout fleet (queue A item 3), and seq2seq
(item 4).
"""

import dataclasses
import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from trlx_tpu_torch.data import PPORLBatch, PPORLElement
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.models.policy import HydraReference, forward_policy_and_ref
from trlx_tpu_torch.models.transformer import position_ids
from trlx_tpu_torch.ops import quant
from trlx_tpu_torch.ops.ppo import AdaptiveKLController, FixedKLController, get_advantages_and_returns, ppo_loss
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base_trainer import TorchTrainer
from trlx_tpu_torch.utils import Clock, flatten_dict, infinite_dataloader, logging
from trlx_tpu_torch.utils.modeling import RunningMoments, logprobs_of_labels

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


# method flags of features the port does not run yet -> the ROADMAP item
_UNPORTED_METHOD_FLAGS = {
    "multiturn_env": "queue A, item 3 (multi-turn rollouts over the fleet)",
}


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
        if config.model.model_arch_type == "seq2seq":
            raise NotImplementedError("seq2seq PPO is not ported yet (ROADMAP queue A, item 4)")
        for flag, item in _UNPORTED_METHOD_FLAGS.items():
            if getattr(config.method, flag):
                raise NotImplementedError(f"method.{flag} is not ported yet (ROADMAP {item})")
        super().__init__(config, **kwargs)
        self.store = PPORolloutStorage(self.tokenizer.pad_token_id, self.tokenizer.padding_side)
        # the frozen reference (hydra): copies of the top of the model at init
        self.ref_model = HydraReference(self.model.lm, self.split)
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
        """Whether the loss may read the windowed head: only the plain MLP
        value head (the branch's blocks attend over the full sequence). The
        JAX gate's soft-prompt condition is refused at construction."""
        return getattr(self.config.method, "num_value_layers_unfrozen", 0) == 0

    def make_loss_fn(self) -> Callable:
        model = self.model
        method = self.config.method
        pad_id = self.tokenizer.pad_token_id
        window_ok = self._window_loss_ok()

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

            advantages, returns = get_advantages_and_returns(
                old_values, old_rewards, method.gamma, method.lam,
                mask=mask if method.whiten_with_mask else None,
            )

            # the windowed head reads exactly the response window of the
            # [b, t, V] logits; under the value branch the full forward runs
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
                out = model(tokens, attention_mask, positions)[:2]
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

    def make_experience(self, num_rollouts: int = 1024, iter_count: int = 0):
        """Collect rollouts: generate -> decode and reward on the host ->
        the hydra scoring pass (and the trunk cache's fill) -> per-token
        KL-penalized rewards -> store."""
        logger.info("Collecting rollouts")
        clock = Clock()
        elements: List[PPORLElement] = []
        accumulated_stats: List[Dict] = []
        gen_kwargs = self.generate_experience_kwargs or self.generate_kwargs
        while len(elements) < num_rollouts:
            stats: Dict[str, float] = {}
            batch = self._next_prompts()
            n_this = len(np.asarray(batch["input_ids"]))
            clock.tick()
            out = self.generate(batch["input_ids"], batch["attention_mask"], gen_kwargs,
                                spec_k=self._spec_k_effective())
            samples = out["samples"].cpu().numpy()
            stats["time/rollout_generate"] = clock.tick()
            # throughput over the real generated tokens (padding after eos
            # does not count); tick() returns ms
            gen_s = max(stats["time/rollout_generate"] / 1000.0, 1e-9)
            stats["throughput/rollout_tokens_per_s"] = int(out["response_mask"].sum()) / gen_s
            stats["throughput/rollout_requests_per_s"] = n_this / gen_s
            self._accum_spec_stats(out, stats)

            prompt_tensors, sample_outputs, outputs, scores, scores_mask = self._host_process_chunk(
                batch, samples, stats, clock
            )
            all_tokens = torch.from_numpy(np.concatenate([prompt_tensors, sample_outputs], axis=1))
            all_tokens = all_tokens.to(self.device).long()
            scored = self.score(all_tokens)
            # the trunk cache over the same retokenized tokens the scorer saw
            h_cache = self.trunk_cache_fill(all_tokens) if self._trunk_cache_available() else None
            logprobs, values, log_ratio = (x.cpu().numpy() for x in scored[:3])
            mean_kl, mean_kl_per_token = float(scored[3]), float(scored[4])
            elements.extend(self._chunk_to_elements(
                prompt_tensors, sample_outputs, outputs, scores, scores_mask, logprobs, values, log_ratio,
                h_cache,
            ))
            stats["time/rollout_time"] = clock.tick()
            stats["policy/sqrt_kl"] = float(np.sqrt(max(mean_kl, 0.0)))
            stats["policy/kl_per_token"] = float(np.sqrt(max(mean_kl_per_token, 0.0)))
            accumulated_stats.append(stats)
            logger.info(f"[rollout {len(elements)} / {num_rollouts}]")

        stats = {k: sum(xs[k] for xs in accumulated_stats) / len(accumulated_stats) for k in accumulated_stats[-1]}
        stats["kl_ctl_value"] = self.kl_ctl.value
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
        sample_outputs, outputs, scores, scores_mask)."""
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
        sample_outputs = np.full((n_samples, max_new), pad_id, dtype=np.int32)
        for i, o in enumerate(outputs):
            sample_outputs[i, : len(o)] = o

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
        logprobs[i] is the logprob with which all_tokens[i + 1] was drawn.
        With the trunk cache, an element keeps the cache rows of exactly
        its query and response tokens (the loader re-pads them)."""
        pad_id = self.tokenizer.pad_token_id
        start = prompt_tensors.shape[1] - 1
        kl_penalty = -self.kl_ctl.value * log_ratio
        elements = []
        for ix in range(len(sample_outputs)):
            # an empty response keeps one (padding) slot
            n_resp = max(int((sample_outputs[ix] != pad_id).sum()), 1)
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
                response_tensor=sample_outputs[ix, :n_resp],
                logprobs=logprobs[ix, start:end],
                values=values[ix, start:end],
                rewards=rewards,
                h_split=None if h_cache is None else h_cache[ix, : prompt_tensors.shape[1] + n_resp],
            ))
        return elements

    # ------------------------------------------------------------------
    # Self-speculative decode, the int8 decode view, the trunk cache
    # ------------------------------------------------------------------

    def _spec_decode_available(self) -> bool:
        """Whether sampling may run the draft/verify sampler: the JAX gate.
        It needs a real hydra split (the frozen trunk is the draft model),
        one beam and no repetition penalty (its seen set cannot be rolled
        back); MoE, virtual tokens and seq2seq are refused at construction
        in the port. A refusal while the flag is on counts in
        `spec_decode_fallbacks`."""
        if not getattr(self.config.method, "speculative_decode", False):
            return False
        gen_kwargs = self.generate_experience_kwargs or self.generate_kwargs
        ok = (
            self.split > 0
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
        if not (getattr(self.config.method, "quantize_frozen_trunk", False) and self.split > 0):
            return None
        if self._quant_frozen is None:
            self._quant_frozen = quant.quantize_frozen(self.model, self.split)
        return self._quant_frozen

    def _trunk_cache_available(self) -> bool:
        """Whether steps may resume from cached trunk activations: the flag,
        a real hydra split (blocks [0, split) entirely frozen, so the cache
        cannot go stale within a collection) and a value branch tapping at
        or above the split (its input must be derivable from the cache).
        The JAX gate's other conditions (seq2seq, MoE) are refused at
        construction in the port."""
        method = self.config.method
        return (
            bool(getattr(method, "cache_trunk_activations", False))
            and self.split > 0
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
        scoring. (The JAX gate's seq2seq condition is refused at
        construction.)"""
        return (
            not self.stop_sequences
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
                    scalar: bool) -> PPORLBatch:
        """Per-token rewards on the device from the scored response windows
        and the host scores (the JAX `_build_spec_merge_fn`, whose formulas
        the classic scorer shares): the KL penalty on each real response
        token (an empty response keeps one slot), plus a scalar score on
        the last of them or a dense score on each. A PPORLBatch of device
        tensors, stats zero past each response."""
        r = responses.shape[1]
        j = torch.arange(r, device=responses.device)[None, :]
        n_resp = (responses != self.tokenizer.pad_token_id).sum(1, keepdim=True).clamp(min=1)
        valid = (j < n_resp).float()
        rewards = (-float(np.float32(kl_coef))) * logratio_win * valid
        if scalar:
            rewards = rewards + (j == n_resp - 1) * scores_eff[:, :1]
        else:
            rewards = rewards + scores_eff * valid
        return PPORLBatch(query_tensors=prompt_tensors, response_tensors=responses, logprobs=lp_win * valid,
                          values=v_win * valid, rewards=rewards)

    @torch.no_grad()
    def _score_reward(self, prompt_tensors, sample_outputs, scores_eff, kl_coef: float, scalar: bool):
        """The hydra score of query|response and the per-token rewards, all
        on the device (the JAX `_build_score_reward_fn`, mirroring
        `_chunk_to_elements`): the pipelined cycle's classic scorer and the
        speculative one's fallback. Returns (PPORLBatch of device tensors,
        mean_kl, mean_kl_per_token), the last two 0-d tensors."""
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

    def create_train_dataloader(self, seed_offset: int = 0, drop_last: bool = False):
        """A loader over the store, reshuffled per inner epoch. The query
        width is the store's longest query rounded up to a 64-token bucket
        (capped by the prompt budget), the response and stat widths the
        experience budget, so batch shapes stay the same across
        collections."""
        exp_kwargs = self.generate_experience_kwargs or self.generate_kwargs
        exp_max_new = int(exp_kwargs.get("max_new_tokens", 40))
        eval_max_new = int(self.generate_kwargs.get("max_new_tokens", 40))
        budget_q = self.config.train.seq_length - eval_max_new
        obs_q = max((len(e.query_tensor) for e in self.store.history), default=0)
        bucket_q = min(budget_q, -(-obs_q // 64) * 64)
        return self.store.create_loader(
            self.config.train.batch_size, shuffle=True, drop_last=drop_last,
            seed=self.config.train.seed + self.iter_count + seed_offset,
            max_query_len=bucket_q, max_response_len=exp_max_new, max_stat_len=exp_max_new,
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
