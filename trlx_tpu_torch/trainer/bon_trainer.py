"""Best-of-n rejection-sampling distillation (port of the JAX package's
`trainer/bon_trainer.py`).

The simplest critic-free method: sample n candidates a prompt (through
the rollout fleet's `n` fan-out when `train.rollout_backend="fleet"`,
one request a prompt, which the server turns into `Scheduler.submit_n`;
otherwise n passes of the local sampler), score them with the
`reward_fn`, and fine-tune with the SFT step's cross-entropy on each
prompt's argmax winner (the label logprob kernel K7 and its backward).
Scoring may go through the retrying, circuit-breaking reward client
(`serving.remote_reward_fn`): set `method.reward_url`, or pass such a
client as the `reward_fn`.

It subclasses `RFTTrainer` for the CE loss, the store and the loop; only
candidate generation and selection differ (argmax instead of rising
percentile thresholds), and the policy is built critic-free
(`CausalLMPolicy`: no value-head parameters to freeze or carry).
"""

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.rft_trainer import RFTTrainer
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


@dataclass
@register_method
class BONConfig(MethodConfig):
    """Best-of-n method section."""

    gen_kwargs: dict = field(default_factory=dict)
    # candidates sampled a prompt; the argmax one is kept
    best_of_n: int = 8
    # a RewardModelServer's URL: when set and no reward_fn was passed,
    # scoring goes through the retrying, circuit-breaking client
    reward_url: Optional[str] = None


@register_trainer
class BestOfNTrainer(RFTTrainer):
    def __init__(self, config: TRLConfig, **kwargs):
        if config.model.model_arch_type == "seq2seq":
            raise NotImplementedError("best-of-n distillation is causal-only")
        if int(config.method.best_of_n) < 1:
            raise ValueError("method.best_of_n must be >= 1")
        super().__init__(config, **kwargs)
        if self.reward_fn is None and config.method.reward_url:
            from trlx_tpu_torch.serving import remote_reward_fn

            self.reward_fn = remote_reward_fn(config.method.reward_url)
        self._bon_router = None

    def get_arch(self, config: TRLConfig):
        return build_model(config.model, vocab_size=self.tokenizer.vocab_size, seed=config.train.seed,
                           device=self.device, value_head=False)

    def _get_bon_router(self):
        """The ReplicaRouter over `train.rollout_fleet_urls`, built once."""
        if self._bon_router is None:
            from trlx_tpu_torch.inference.fleet import ReplicaRouter

            train = self.config.train
            urls = list(getattr(train, "rollout_fleet_urls", None) or [])
            if not urls:
                raise ValueError("train.rollout_backend='fleet' needs train.rollout_fleet_urls")
            kwargs = dict(getattr(train, "rollout_fleet_kwargs", None) or {})
            self._bon_router = ReplicaRouter(urls, **kwargs)
        return self._bon_router

    def shutdown_rollout_fleet(self) -> None:
        """Close the router (its probe threads); `learn()` calls it on the
        way out."""
        router, self._bon_router = self._bon_router, None
        if router is not None:
            router.close()

    def _sample_candidates(self, input_ids, attention_mask, n: int):
        """Each prompt's candidate outputs as a [n_prompts][n] list of
        decoded strings. Fleet backend: one request a prompt with the
        server's `n` fan-out; local (or degraded) backend: n batched
        passes of `generate` over the prompts."""
        backend = getattr(self.config.train, "rollout_backend", "local")
        max_new = int(self.config.method.gen_kwargs.get("max_new_tokens", 40))
        n_prompts, plen = input_ids.shape
        pad_id = self.tokenizer.pad_token_id

        if backend == "fleet":
            from trlx_tpu_torch.inference.fleet import FleetUnavailableError

            prompts = [[int(t) for t, m in zip(row, mask) if m] for row, mask in zip(input_ids, attention_mask)]
            try:
                replies = self._get_bon_router().generate(prompts, max_new_tokens=max_new, n=n)
            except FleetUnavailableError as e:
                logger.warning_once(f"best-of-n fleet unavailable; sampling locally ({e})")
            else:
                candidates = [[] for _ in range(n_prompts)]
                for g in range(n):
                    samples = np.full((n_prompts, plen + max_new), pad_id, np.int32)
                    samples[:, :plen] = input_ids
                    for p, rep in enumerate(replies):
                        seqs = rep.get("sequences") or [rep]
                        toks = list(seqs[min(g, len(seqs) - 1)]["token_ids"])[:max_new]
                        samples[p, plen:plen + len(toks)] = toks
                    _, _, str_outputs = self.decode(input_ids, samples, append_eos_token=True)
                    for p, o in enumerate(str_outputs):
                        candidates[p].append(o)
                return candidates

        candidates = [[] for _ in range(n_prompts)]
        for _ in range(n):
            samples = self.generate(input_ids, attention_mask)["samples"].cpu().numpy()
            _, _, str_outputs = self.decode(input_ids, samples, append_eos_token=True)
            for p, o in enumerate(str_outputs):
                candidates[p].append(o)
        return candidates

    def make_experience(self):
        """One distillation round: sample n a prompt, score, keep the
        argmax winner, and store prompt + winner for the CE steps."""
        if self.reward_fn is None:
            raise ValueError("BestOfNTrainer needs a reward_fn (or method.reward_url)")
        n = int(self.config.method.best_of_n)
        winners, win_scores, all_scores = [], [], []
        for batch in self.prompt_dataloader:
            input_ids = np.asarray(batch["input_ids"])
            attention_mask = np.asarray(batch["attention_mask"])
            _, str_prompts, _ = self.decode(input_ids, input_ids, append_eos_token=False)
            candidates = self._sample_candidates(input_ids, attention_mask, n)
            flat_prompts = [p for p, cs in zip(str_prompts, candidates) for _ in cs]
            flat_outputs = [o for cs in candidates for o in cs]
            scores = self.reward_fn(samples=[p + o for p, o in zip(flat_prompts, flat_outputs)],
                                    prompts=flat_prompts, outputs=flat_outputs)
            scores = np.asarray([float(np.sum(np.asarray(s))) for s in scores],
                                dtype=np.float32).reshape(len(candidates), n)
            all_scores.append(scores.reshape(-1))
            for p, (prompt, cs) in enumerate(zip(str_prompts, candidates)):
                best = int(np.argmax(scores[p]))
                winners.append(prompt + cs[best])
                win_scores.append(float(scores[p, best]))

        self.tracker.log({
            "bon/scores_mean": float(np.mean(np.hstack(all_scores))) if all_scores else 0.0,
            "bon/winner_scores_mean": float(np.mean(win_scores)) if win_scores else 0.0,
            "bon/n_winners": len(winners),
        }, step=self.iter_count)
        if winners:
            self.store = PromptPipeline(winners, max_prompt_length=self.config.train.seq_length,
                                        tokenizer=self.tokenizer)
