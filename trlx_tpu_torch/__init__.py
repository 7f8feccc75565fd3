"""PyTorch/CUDA port of trlx_tpu for NVIDIA Hopper (H100).

A second package beside `trlx_tpu`, mirroring its module paths and
names so every module has a findable counterpart. It imports torch and
numpy only — never jax, flax, optax or anything of `trlx_tpu` — and
keeps its own copies of the framework-free modules it needs.

Slices ported so far (ROADMAP.md, queue A):

- serving: `SFTTrainer(config).serve()` -> `InferenceEngine` (paged KV)
  -> `Scheduler` -> `InferenceServer`, with the paged-attention decode
  kernel hand-written in CUDA for sm_90a (`csrc/paged_attention.cu`);
- supervised fine-tuning: `trlx_tpu_torch.train(samples=..., config=...)`
  -> `SFTTrainer.learn()`, with causal flash attention forward and
  backward (`csrc/flash_attention.cu`) and the fused label logprob of the
  CE loss and its gradient (`csrc/fused_ce.cu`) hand-written in CUDA;
- PPO: `trlx_tpu_torch.train(reward_fn=..., prompts=..., config=...)` ->
  `PPOTrainer.learn()`: rollouts from the sampler, one no-grad hydra
  scoring pass a chunk (policy, values and the frozen reference), the
  clipped PPO step over the windowed head, on the same kernels; with the
  JAX bench's options, its pipelined cycle and the deeper value branch;
- ILQL: `trlx_tpu_torch.train(samples=..., rewards=..., config=...)` ->
  `ILQLTrainer.learn()`: Q, target Q and V heads over the LM, the ILQL
  loss, Polyak target syncs and Q-guided sampling, on the same kernels.
- GRPO/RLOO, RFT and best-of-n through `train(reward_fn=...)`, the
  reward model (`models/reward.py`) and its server (`serving.py`), the
  rollout fleet, and training's resilience (`sentinel.py`, the
  watchdog, `auto_resume`, the server's SIGTERM drain).

Entry points run on `cuda` unless the caller passes `device="cpu"`;
asking for `cuda` where there is none raises.
"""

__version__ = "0.1.0"


def train(*args, **kwargs):
    """`trlx_tpu_torch.trlx.train`, imported at first call so that
    `import trlx_tpu_torch` stays light."""
    from trlx_tpu_torch.trlx import train as _train

    return _train(*args, **kwargs)
