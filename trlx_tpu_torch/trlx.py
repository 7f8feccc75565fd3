"""The `train()` entry point (port of the JAX package's `trlx.py`).

Samples without rewards run supervised fine-tuning; online RL
(`reward_fn`) and offline RL (`rewards`) are not ported yet.
"""

import warnings
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_sft_config
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
    """Fine-tune on `samples` (strings, or alternating prompt/output
    dialogues) and return the trainer. Same signature as the JAX
    package's `train`, plus `device` (`cuda` unless the caller passes
    another; "cpu" runs the kernels' plain versions)."""
    if reward_fn is not None:
        raise NotImplementedError("online RL (reward_fn: PPO/RFT) is not ported yet (ROADMAP queue A, item 2)")
    if dataset:
        warnings.warn("the `dataset` argument is deprecated, split it into `samples` and `rewards`")
        samples, rewards = dataset
    if rewards is not None:
        raise NotImplementedError("offline RL (rewards: ILQL) is not ported yet (ROADMAP queue A, item 4)")
    if not samples:
        raise ValueError("Either `samples` or `reward_fn` should be given for training")
    if config is None:
        warnings.warn(
            "Passing the `config` argument implicitly is deprecated, adapt one "
            "from `trlx_tpu_torch/data/default_configs.py` instead"
        )
        config = default_sft_config()
    set_seed(config.train.seed)
    if model_path:
        config.model.model_path = model_path

    trainer = get_trainer(config.train.trainer)(
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
    if eval_prompts is None:
        eval_prompts = [trainer.tokenizer.bos_token] * batch_size
    trainer.make_experience(samples, config.train.seq_length)
    eval_pipeline = get_pipeline(config.train.pipeline)(
        eval_prompts,
        max_prompt_length,
        trainer.tokenizer,
        add_special_tokens=config.model.model_arch_type == "seq2seq",
    )
    trainer.add_eval_pipeline(eval_pipeline)
    trainer.learn()
    return trainer
