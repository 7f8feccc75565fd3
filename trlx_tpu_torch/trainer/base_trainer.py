"""Base trainer: construction and serving.

Port of the JAX package's `trainer/base_trainer.py` for the serving
slice: the trainer builds the tokenizer and the policy (`get_arch`) on its
device and serves it (`serve`, mirroring the JAX `serve`). The learn
loop, optimizer and checkpointing come with the training slice.
"""

from typing import Dict, Optional

import torch

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.tokenizers import get_tokenizer
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.utils import logging, resolve_device

logger = logging.get_logger(__name__)


@register_trainer
class TorchTrainer:
    """:param device: where the policy lives and runs; `cuda` unless the
    caller asks for another (the tests pass "cpu"). Asking for `cuda`
    where there is none raises."""

    def __init__(self, config: TRLConfig, device=None, **kwargs):
        self.config = config
        self.device = resolve_device(device)
        torch.manual_seed(config.train.seed)
        self.tokenizer = get_tokenizer(config.tokenizer)
        self.model, self.model_cfg, _ = self.get_arch(config)
        self.generate_kwargs = dict(getattr(config.method, "gen_kwargs", None) or {})
        n = sum(p.numel() for p in self.model.parameters())
        logger.info(f"Policy params: {n:,} on {self.device}")

    def get_arch(self, config: TRLConfig):
        """Returns (module, model config, state dict)."""
        raise NotImplementedError

    def learn(self):
        raise NotImplementedError("training is not ported yet (ROADMAP queue A, PPO training)")

    def serving_params(self) -> Dict[str, torch.Tensor]:
        """Param state handed to a long-lived consumer (an inference
        engine). Nothing in this package updates the weights in place
        while serving, so the live tensors are shared, not copied."""
        return self.model.state_dict()

    def serve(self, host: Optional[str] = None, port: Optional[int] = None,
              watch_dir: Optional[str] = None, background: bool = False):
        """Serve the current policy through the continuous-batching
        inference server (config section: `inference`). Generation knobs
        come from the method's gen_kwargs overlaid with
        `inference.gen_kwargs`; `inference.max_new_tokens` caps the
        per-request budget and sizes the KV pool. `background=True`
        starts a daemon thread and returns the `InferenceServer` (its
        `.url` is the base endpoint); otherwise this blocks serving."""
        from trlx_tpu_torch.inference import InferenceEngine, InferenceServer, Scheduler
        from trlx_tpu_torch.ops.sampling import GenerationConfig

        icfg = self.config.inference
        if icfg.sessions:
            raise NotImplementedError("chat sessions are not ported yet (ROADMAP queue A, serving features)")
        gen_kwargs = {**self.generate_kwargs, **(icfg.gen_kwargs or {})}
        gen_kwargs.setdefault("max_new_tokens", icfg.max_new_tokens)
        gen_kwargs["max_new_tokens"] = min(int(gen_kwargs["max_new_tokens"]), icfg.max_new_tokens)
        gen_cfg = GenerationConfig.from_gen_kwargs(
            gen_kwargs, self.tokenizer.eos_token_id, self.tokenizer.pad_token_id
        )
        engine = InferenceEngine(
            self.model, self.model_cfg, self.serving_params(), gen_cfg,
            num_slots=icfg.num_slots,
            max_prompt_len=icfg.max_prompt_len,
            max_prefill_batch=icfg.max_prefill_batch,
            prompt_bucket=icfg.prompt_bucket,
            seed=self.config.train.seed,
            kv_paging=icfg.kv_paging,
            kv_block_size=icfg.kv_block_size,
            kv_pool_blocks=icfg.kv_pool_blocks,
            kv_cache_dtype=icfg.kv_cache_dtype,
            prefix_cache=icfg.prefix_cache,
            prefix_cache_capacity=icfg.prefix_cache_capacity,
            multi_tenant=icfg.multi_tenant,
            decode_kernel=icfg.decode_kernel,
        )
        tracer = None
        if icfg.tracing:
            from trlx_tpu_torch.observability.tracing import Tracer

            tracer = Tracer(max_traces=icfg.trace_ring, sample_rate=icfg.trace_sample_rate)
        scheduler = Scheduler(
            engine,
            max_queue_depth=icfg.max_queue_depth,
            max_wait_s=icfg.max_wait_s,
            default_deadline_s=icfg.default_deadline_s,
            tracer=tracer,
        )
        server = InferenceServer(
            scheduler,
            tokenizer=self.tokenizer,
            host=host if host is not None else icfg.host,
            port=port if port is not None else icfg.port,
            watch_dir=watch_dir if watch_dir is not None else icfg.watch_dir,
        )
        if background:
            server.start_background()
            return server
        server.serve()
        return server
