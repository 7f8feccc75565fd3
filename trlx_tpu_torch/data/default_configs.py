"""Canonical default configs (the JAX package's `default_sft_config`;
the other methods' defaults come with their trainers)."""

from trlx_tpu_torch.data.configs import (
    ModelConfig,
    OptimizerConfig,
    ParallelConfig,
    SchedulerConfig,
    TokenizerConfig,
    TrainConfig,
    TRLConfig,
)
from trlx_tpu_torch.trainer.sft_trainer import SFTConfig


def default_sft_config():
    """Mirrors reference default_sft_config (default_configs.py:97-121)."""
    return TRLConfig(
        train=TrainConfig(
            seq_length=1024,
            epochs=100,
            total_steps=1000,
            batch_size=8,
            checkpoint_interval=10000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="SFTTrainer",
            tracker=None,
        ),
        model=ModelConfig(model_path="random:gpt2-small", num_layers_unfrozen=-1),
        tokenizer=TokenizerConfig(tokenizer_path="byte", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw", kwargs=dict(lr=1.0e-4, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6)
        ),
        scheduler=SchedulerConfig(name="cosine_annealing", kwargs=dict(T_max=1e12, eta_min=1.0e-4)),
        method=SFTConfig(
            name="sftconfig",
            gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
        ),
        parallel=ParallelConfig(),
    )
