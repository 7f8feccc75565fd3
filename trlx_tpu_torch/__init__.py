"""PyTorch/CUDA port of trlx_tpu for NVIDIA Hopper (H100).

A second package beside `trlx_tpu`, mirroring its module paths and
names so every module has a findable counterpart. It imports torch and
numpy only — never jax, flax, optax or anything of `trlx_tpu` — and
keeps its own copies of the framework-free modules it needs.

Slices ported so far (ROADMAP.md, queue A):

- serving: `SFTTrainer(config).serve()` -> `InferenceEngine` (paged KV)
  -> `Scheduler` -> `InferenceServer`, with the paged-attention decode
  kernel hand-written in CUDA for sm_90a (`csrc/paged_attention.cu`).

Entry points run on `cuda` unless the caller passes `device="cpu"`;
asking for `cuda` where there is none raises.
"""

__version__ = "0.1.0"
