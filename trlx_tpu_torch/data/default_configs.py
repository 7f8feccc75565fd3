"""Canonical default configs (the JAX package's `default_ppo_config`,
`default_ilql_config`, `default_sft_config`, `default_rft_config` and
`default_grpo_config`; best-of-n's comes with its trainer)."""

from trlx_tpu_torch.data.configs import (
    ModelConfig,
    OptimizerConfig,
    ParallelConfig,
    SchedulerConfig,
    TokenizerConfig,
    TrainConfig,
    TRLConfig,
)
from trlx_tpu_torch.trainer.bon_trainer import BONConfig
from trlx_tpu_torch.trainer.grpo_trainer import GRPOConfig
from trlx_tpu_torch.trainer.ilql_trainer import ILQLConfig
from trlx_tpu_torch.trainer.ppo_trainer import PPOConfig
from trlx_tpu_torch.trainer.sft_trainer import SFTConfig


def default_ppo_config():
    """Mirrors reference default_ppo_config (default_configs.py:17-59)."""
    return TRLConfig(
        train=TrainConfig(
            seq_length=1024,
            epochs=100,
            total_steps=10000,
            batch_size=32,
            checkpoint_interval=10000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="PPOTrainer",
            tracker=None,
            auto_resume=False,
            checkpoint_keep_n=3,
        ),
        model=ModelConfig(model_path="random:gpt2-small", num_layers_unfrozen=2),
        tokenizer=TokenizerConfig(tokenizer_path="byte", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw", kwargs=dict(lr=3e-5, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6)
        ),
        scheduler=SchedulerConfig(name="cosine_annealing", kwargs=dict(T_max=1e12, eta_min=3e-5)),
        method=PPOConfig(
            name="PPOConfig",
            num_rollouts=128,
            chunk_size=128,
            ppo_epochs=4,
            init_kl_coef=0.001,
            target=None,
            horizon=10000,
            gamma=1,
            lam=0.95,
            cliprange=0.2,
            cliprange_value=0.2,
            vf_coef=1,
            scale_reward="ignored",
            ref_mean=None,
            ref_std=None,
            cliprange_reward=10,
            gen_kwargs=dict(
                max_new_tokens=40,
                top_k=0,
                top_p=1.0,
                do_sample=True,
            ),
        ),
        parallel=ParallelConfig(),
    )


def default_ilql_config():
    """Mirrors reference default_ilql_config (default_configs.py:62-94)."""
    return TRLConfig(
        train=TrainConfig(
            seq_length=64,
            batch_size=128,
            epochs=100,
            total_steps=1000,
            checkpoint_interval=1000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="ILQLTrainer",
            tracker=None,
        ),
        model=ModelConfig(model_path="random:gpt2-small", num_layers_unfrozen=-1),
        tokenizer=TokenizerConfig(tokenizer_path="byte", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw", kwargs=dict(lr=5.0e-5, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6)
        ),
        scheduler=SchedulerConfig(name="cosine_annealing", kwargs=dict(T_max=1e12, eta_min=5.0e-5)),
        method=ILQLConfig(
            name="ilqlconfig",
            tau=0.7,
            gamma=0.99,
            cql_scale=0.1,
            awac_scale=1,
            alpha=0.001,
            beta=0,
            steps_for_target_q_sync=5,
            two_qs=True,
            gen_kwargs=dict(max_new_tokens=56, top_k=20, beta=1, temperature=1.0),
        ),
        parallel=ParallelConfig(),
    )


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


def default_rft_config():
    """Mirrors the JAX package's default_rft_config: SFT's defaults with
    RFTTrainer and trlX's RFTConfig."""
    return default_sft_config().evolve(
        train=dict(trainer="RFTTrainer"),
        method=dict(
            name="rftconfig",
            gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
            start_percentile=0.7,
            end_percentile=0.95,
            n_improve_steps=4,
            n_generations_per_prompt=32,
        ),
    )


def default_grpo_config():
    """Critic-free GRPO defaults (the JAX package's default_grpo_config):
    the PPO stack minus the value function, plus the group knobs.
    `advantage_mode="rloo"` switches to the leave-one-out baseline. The
    method section is swapped whole, not merged, so no value-function
    field survives."""
    cfg = default_ppo_config().to_dict()
    cfg["train"]["trainer"] = "GRPOTrainer"
    cfg["method"] = GRPOConfig(
        name="GRPOConfig",
        num_rollouts=128,
        chunk_size=128,
        ppo_epochs=4,
        group_size=8,
        advantage_mode="grpo",
        grpo_kl_coef=0.02,
        init_kl_coef=0.0,
        target=None,
        horizon=10000,
        cliprange=0.2,
        scale_reward=None,
        ref_mean=None,
        ref_std=None,
        cliprange_reward=10,
        gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
    ).to_dict()
    return TRLConfig.from_dict(cfg)


def default_bon_config():
    """Best-of-n rejection-sampling distillation defaults."""
    cfg = default_sft_config().to_dict()
    cfg["train"]["trainer"] = "BestOfNTrainer"
    cfg["method"] = BONConfig(
        name="BONConfig",
        gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
        best_of_n=8,
    ).to_dict()
    return TRLConfig.from_dict(cfg)
