"""RFT (rejection-sampling fine-tuning) trainer (port of the JAX package's
`trainer/rft_trainer.py`, itself trlX's `AccelerateRFTTrainer`).

Every `n_improve_steps` growth steps, each prompt batch is sampled
`n_generations_per_prompt` times and every generation scored by the
`reward_fn`. Each growth step keeps, per prompt, the generations at or
above a percentile of that prompt's scores that rises from
`start_percentile` to `end_percentile`, clipped so a quantized reward
neither keeps every minimum nor drops every maximum; the survivors are
deduplicated and sorted, and the model fine-tunes on them with the SFT
step: cross-entropy over every real token, prompt included, through the
label logprob kernel (K7) and its backward. The value head is frozen, as
in the JAX package.
"""

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer


@dataclass
@register_method
class RFTConfig(MethodConfig):
    """Config for RFT (trlX's accelerate_rft_trainer.py RFTConfig)."""

    gen_kwargs: dict = field(default_factory=dict)
    start_percentile: float = 0.7
    end_percentile: float = 0.95
    n_improve_steps: int = 4
    n_generations_per_prompt: int = 32


def select_generations(generations_per_prompt, percentile: float):
    """The survivors of one growth step: per prompt, the generations whose
    score is at or above the prompt's `percentile` quantile, the thresholds
    clipped into [min + 1e-3, max - 1e-3] over the prompts, then
    deduplicated and sorted. Returns (sorted (prompt, output) pairs, the
    thresholds, every prompt's scores)."""
    scores = [[x["score"] for x in generations_per_prompt[p]] for p in generations_per_prompt]
    thresholds = np.array([np.quantile(np.array(s), percentile) for s in scores])
    # the quantized-reward corner case: exclude min values, keep max values
    thresholds = np.clip(thresholds, thresholds.min() + 1e-3, thresholds.max() - 1e-3)
    selected = []
    for prompt, threshold in zip(generations_per_prompt, thresholds):
        for x in generations_per_prompt[prompt]:
            if x["score"] >= threshold:
                selected.append((prompt, x["output"]))
    return sorted(set(selected)), thresholds, scores


@register_trainer
class RFTTrainer(SFTTrainer):
    """The SFT trainer's model (value head frozen), CE loss and loader over
    a store that each growth step rebuilds from the selected generations."""

    def __init__(self, config: TRLConfig, **kwargs):
        super().__init__(config, **kwargs)
        self.generations_per_prompt = defaultdict(list)
        self.epoch_count = 0

    def add_prompt_pipeline(self, pipeline: PromptPipeline):
        self.prompt_dataloader = pipeline.create_loader(self.config.train.batch_size)

    def make_experience(self):
        """One growth step (trlX accelerate_rft_trainer.py:117-197): sample
        and score on every `n_improve_steps`-th call, then select at this
        step's percentile and rebuild the training store."""
        method = self.config.method
        if self.epoch_count % method.n_improve_steps == 0:
            generations = []
            for batch in self.prompt_dataloader:
                for _ in range(method.n_generations_per_prompt):
                    samples = self.generate(batch["input_ids"], batch["attention_mask"])["samples"].cpu().numpy()
                    _, str_prompts, str_outputs = self.decode(np.asarray(batch["input_ids"]), samples,
                                                              append_eos_token=True)
                    generations.extend({"prompt": p, "output": o} for p, o in zip(str_prompts, str_outputs))
            all_scores = self.reward_fn(
                samples=[x["prompt"] + x["output"] for x in generations],
                prompts=[x["prompt"] for x in generations],
                outputs=[x["output"] for x in generations],
            )
            for g, s in zip(generations, all_scores):
                self.generations_per_prompt[g["prompt"]].append({"output": g["output"],
                                                                 "score": float(np.sum(np.asarray(s)))})

        percentile_delta = (method.end_percentile - method.start_percentile) / method.n_improve_steps
        percentile = method.start_percentile + percentile_delta * (self.epoch_count % method.n_improve_steps)
        selected, thresholds, scores = select_generations(self.generations_per_prompt, percentile)
        self.tracker.log({
            "rft/scores_mean": float(np.mean(np.hstack(scores))) if scores else 0.0,
            "rft/len_samples_selected": len(selected),
            "rft/threshold_mean": float(thresholds.mean()) if len(thresholds) else 0.0,
        }, step=self.iter_count)
        if selected:
            self.store = PromptPipeline([p + o for p, o in selected], max_prompt_length=self.config.train.seq_length,
                                        tokenizer=self.tokenizer)

    def post_epoch_callback(self):
        self.epoch_count += 1
        self.make_experience()

    def prepare_learning(self):
        self.epoch_count = 0
        self.n_inner_epochs = 1
        self.total_steps = self.config.train.total_steps
        self.eval_dataloader = self.eval_pipeline.create_loader(self.config.train.batch_size)
        self.make_experience()
        self.train_dataloader = self.create_train_dataloader()
