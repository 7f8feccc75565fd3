"""Policy wrapper: LM + value head, and the freezing utilities.

Port of the JAX package's `models/policy.py`: `CausalLMWithValueHead`
with the MLP value head (the training forward, the cached decode steps
of the sampler and the inference engine), `resolve_split` and
`trainable_mask`. The hydra reference branch and the deeper value branch
are ROADMAP queue A, item 1 (rollout and scoring); LoRA and prompt
tuning are refused at model build until they port (item 4).
"""

from typing import Dict

from torch import nn

from trlx_tpu_torch.models.heads import MLPHead
from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM


class CausalLMWithValueHead(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.lm = TransformerLM(cfg, device, generator)
        self.v_head = MLPHead(cfg.d_model, 1, cfg.dtype, cfg.param_dtype, device, generator)

    def forward(self, tokens, attn_mask, positions=None, split: int = 0):
        """Returns (logits, values, h_split). `split` is the hydra branch
        point (0: h_split is the embedding output)."""
        logits, h_split, h_final = self.lm(tokens, attn_mask, positions, split)
        values = self.v_head(h_final)[..., 0]
        return logits, values, h_split

    def decode_step(self, tokens, cache, token_mask, is_prefill: bool = False):
        """Cached decode over the fixed-slot cache (the sampler's). Returns
        (logits, new_cache)."""
        logits, _, new_cache = self.lm.decode_step(tokens, cache, token_mask, is_prefill)
        return logits, new_cache

    def decode_step_rows(self, tokens, cache, token_mask, attn_kernel=None):
        """Per-row-offset cached decode (continuous-batching slot pool).
        Returns (logits, new_cache)."""
        return self.lm.decode_step_rows(tokens, cache, token_mask, attn_kernel)

    def prefill_rows(self, tokens, cache, token_mask):
        """Per-row-offset multi-token prefill (the paged engine's insert
        path). Returns (logits, new_cache)."""
        return self.lm.prefill_rows(tokens, cache, token_mask)


def resolve_split(cfg: TransformerConfig, num_layers_unfrozen: int) -> int:
    """Map `num_layers_unfrozen` to the hydra split layer: -1 = everything
    trainable (split 0), 0 = the whole LM frozen (split n_layers), k > 0 =
    the top k blocks trainable."""
    if num_layers_unfrozen == -1:
        return 0
    if num_layers_unfrozen == 0:
        return cfg.n_layers
    return max(cfg.n_layers - num_layers_unfrozen, 0)


def trainable_mask(model: nn.Module, cfg: TransformerConfig, num_layers_unfrozen: int) -> Dict[str, bool]:
    """{parameter name: trainable}. Heads (anything outside `lm`) are
    trainable; in the LM, -1 = all, 0 = none, k > 0 = the top k blocks and
    the final norm (and an untied lm_head) — the embeddings stay frozen,
    as the reference's freeze_bottom_causal_layers does."""
    split = resolve_split(cfg, num_layers_unfrozen)

    def _trainable(name: str) -> bool:
        parts = name.split(".")
        if parts[0] != "lm":
            return True
        if num_layers_unfrozen == -1:
            return True
        if num_layers_unfrozen == 0:
            return False
        if parts[1].startswith("block_"):
            return int(parts[1].split("_")[1]) >= split
        return parts[1] in ("ln_f", "lm_head")

    return {name: _trainable(name) for name, _ in model.named_parameters()}
