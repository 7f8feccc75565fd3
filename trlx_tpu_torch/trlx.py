"""The `train()` entry point (port of the JAX package's `trlx.py`).

Samples without rewards run supervised fine-tuning; samples with
`rewards` run offline RL with ILQL; a `reward_fn` runs online RL with
PPO, GRPO/RLOO (`default_grpo_config`), RFT (`default_rft_config`) or
best-of-n (`default_bon_config`; `serving.remote_reward_fn(url)` scores
through a reward server). `model_path` (or `config.model.model_path`) is a
`random:<preset>` or a local HF checkpoint directory of a ported family;
`model.model_arch_type="seq2seq"` takes the encoder-decoder (t5) presets
and directories, whose prompts are tokenized with special tokens.
"""

import warnings
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ilql_config, default_ppo_config, default_sft_config
from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.trainer.rft_trainer import RFTTrainer
from trlx_tpu_torch.utils import set_seed
from trlx_tpu_torch.utils.loading import get_pipeline, get_trainer


def train(
    model_path: Optional[str] = None,
    reward_fn: Optional[Callable[[List[str], List[str], List[str]], List[float]]] = None,
    dataset: Optional[Iterable[Tuple[str, float]]] = None,
    samples: Optional[List[str]] = None,
    rewards: Optional[List[float]] = None,
    prompts: Optional[List[str]] = None,
    eval_prompts: Optional[List[str]] = None,
    metric_fn: Optional[Callable[[List[str], List[str], List[str]], Dict[str, List[float]]]] = None,
    config: Optional[TRLConfig] = None,
    stop_sequences: Optional[List[str]] = [],
    logit_mask=None,
    device=None,
):
    """Train with PPO, GRPO/RLOO, RFT or best-of-n (by `config.train.trainer`)
    against `reward_fn` over `prompts`, with ILQL on
    `samples` labelled by `rewards`, or fine-tune on `samples` (strings,
    or alternating prompt/output dialogues), and return the trainer.
    Same signature as the JAX package's `train`, plus `device` (`cuda`
    unless the caller passes another; "cpu" runs the kernels' plain
    versions)."""
    if dataset:
        warnings.warn("the `dataset` argument is deprecated, split it into `samples` and `rewards`")
        samples, rewards = dataset
    if not reward_fn and not samples:
        raise ValueError("Either `samples` or `reward_fn` should be given for training")
    if not reward_fn and rewards is not None and len(samples) != len(rewards):
        raise ValueError(f"Number of samples {len(samples)} should match the number of rewards {len(rewards)}")
    if config is None:
        warnings.warn(
            "Passing the `config` argument implicitly is deprecated, adapt one "
            "from `trlx_tpu_torch/data/default_configs.py` instead"
        )
        if reward_fn:
            config = default_ppo_config()
        elif rewards:
            config = default_ilql_config()
        else:
            config = default_sft_config()
    online = bool(reward_fn)
    if online or rewards is not None:
        # the trainers of the branch that are not ported yet are refused
        want, others = ((PPOTrainer, RFTTrainer), "the pipelined and sequence-parallel trainers") if online \
            else ((ILQLTrainer,), "1F1B, ...")
        try:
            trainer_cls = get_trainer(config.train.trainer)
        except ValueError:  # not registered in the port
            trainer_cls = None
        if trainer_cls is None or not issubclass(trainer_cls, want):
            raise NotImplementedError(
                f"{'online' if online else 'offline'} RL with {config.train.trainer} ({others}) is not ported "
                f"yet; {' and '.join(c.__name__ for c in want)} (and their subclasses) are (ROADMAP queue A, item 4)"
            )
    else:
        trainer_cls = get_trainer(config.train.trainer)
    set_seed(config.train.seed)
    if model_path:
        config.model.model_path = model_path

    trainer = trainer_cls(
        config=config,
        reward_fn=reward_fn,
        metric_fn=metric_fn,
        stop_sequences=stop_sequences,
        logit_mask=logit_mask,
        device=device,
        **config.train.trainer_kwargs,
    )
    batch_size = config.train.batch_size
    max_prompt_length = config.train.seq_length - config.method.gen_kwargs.get("max_new_tokens", 40)
    pipeline_cls = get_pipeline(config.train.pipeline)
    add_special_tokens = config.model.model_arch_type == "seq2seq"
    if reward_fn:
        prompts = prompts or [trainer.tokenizer.bos_token] * batch_size
        if eval_prompts is None:
            eval_prompts = prompts[:batch_size]
        trainer.add_prompt_pipeline(
            pipeline_cls(prompts, max_prompt_length, trainer.tokenizer, add_special_tokens=add_special_tokens)
        )
    else:
        if eval_prompts is None:
            eval_prompts = [trainer.tokenizer.bos_token] * batch_size
        if rewards is not None:
            trainer.make_experience(samples, rewards, config.train.seq_length)
        else:
            trainer.make_experience(samples, config.train.seq_length)
    eval_pipeline = pipeline_cls(eval_prompts, max_prompt_length, trainer.tokenizer,
                                 add_special_tokens=add_special_tokens)
    trainer.add_eval_pipeline(eval_pipeline)
    trainer.learn()
    return trainer
