"""Policy wrapper: LM + value head (port of the JAX package's
`models/policy.py:CausalLMWithValueHead`, serving methods only).

The value head is kept so the parameter tree matches the JAX one
(`lm/...`, `v_head/...`); serving never evaluates it. The training
forward, hydra reference branch and freezing utilities come with the
training slice.
"""

from torch import nn

from trlx_tpu_torch.models.heads import MLPHead
from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM


class CausalLMWithValueHead(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.lm = TransformerLM(cfg, device, generator)
        self.v_head = MLPHead(cfg.d_model, 1, cfg.dtype, cfg.param_dtype, device, generator)

    def decode_step_rows(self, tokens, cache, token_mask, attn_kernel=None):
        """Per-row-offset cached decode (continuous-batching slot pool).
        Returns (logits, new_cache)."""
        return self.lm.decode_step_rows(tokens, cache, token_mask, attn_kernel)

    def prefill_rows(self, tokens, cache, token_mask):
        """Per-row-offset multi-token prefill (the paged engine's insert
        path). Returns (logits, new_cache)."""
        return self.lm.prefill_rows(tokens, cache, token_mask)
