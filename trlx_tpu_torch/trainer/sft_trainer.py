"""Supervised fine-tuning trainer (port of the JAX package's
`trainer/sft_trainer.py`): CE loss over samples — strings put the loss
on every real token, dialogues only on the output tokens (DialogStore
labels)."""

from dataclasses import dataclass, field
from typing import Callable, Dict

import torch

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.models.transformer import position_ids
from trlx_tpu_torch.pipeline.offline_pipeline import DialogStore, PromptPipeline, tokenize_dialogue
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base_trainer import TorchTrainer
from trlx_tpu_torch.utils.modeling import add_moe_aux, apply_with_moe_aux, logprobs_of_labels


@dataclass
@register_method
class SFTConfig(MethodConfig):
    """Config for SFT training."""

    gen_kwargs: dict = field(default_factory=dict)


def ce_shift_labels_and_valid(input_ids, attention_mask, labels=None):
    """The SFT CE targets: labels default to input_ids over real tokens,
    shifted one right, valid where not IGNORE_INDEX and attended."""
    ignore_index = DialogStore.IGNORE_INDEX
    if labels is None:
        labels = torch.where(attention_mask > 0, input_ids, torch.full_like(input_ids, ignore_index))
    shift_labels = labels[:, 1:]
    valid = (shift_labels != ignore_index) & (attention_mask[:, 1:] > 0)
    return shift_labels, valid


def causal_lm_ce_loss(logits, input_ids, attention_mask, labels=None):
    """Shifted CE over the valid tokens: (loss, {"loss": loss}). The label
    logprob reads the full, contiguous logits with the labels shifted one
    column (the last column gets label 0 and is dropped), so the
    [b, t - 1, V] slice is never copied, nor zero-filled in the backward."""
    shift_labels, valid = ce_shift_labels_and_valid(input_ids, attention_mask, labels)
    safe_labels = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    safe_labels = torch.cat([safe_labels, torch.zeros_like(safe_labels[:, :1])], dim=1)
    nll = -logprobs_of_labels(logits, safe_labels)[:, :-1]
    n = valid.sum().clamp(min=1)
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / n
    return loss, {"loss": loss.detach()}


@register_trainer
class SFTTrainer(TorchTrainer):
    def get_arch(self, config: TRLConfig):
        return build_model(
            config.model,
            vocab_size=self.tokenizer.vocab_size,
            seed=config.train.seed,
            device=self.device,
        )

    def make_trainable_mask(self) -> Dict[str, bool]:
        # the (unused) value head stays frozen so weight decay cannot drift it
        mask = super().make_trainable_mask()
        return {k: (False if k.startswith("v_head.") else v) for k, v in mask.items()}

    def make_loss_fn(self) -> Callable:
        """The shifted CE; under MoE plus the load-balancing term, with
        `moe_aux_loss` in the stats and `loss` the optimised sum (RFT and
        best-of-n inherit it)."""
        model, model_cfg = self.model, self.model_cfg

        def loss_fn(batch):
            input_ids, attention_mask = batch["input_ids"], batch["attention_mask"]
            (logits, _, _), aux = apply_with_moe_aux(model_cfg, model, input_ids, attention_mask,
                                                     position_ids(attention_mask))
            loss, stats = causal_lm_ce_loss(logits, input_ids, attention_mask, batch.get("labels"))
            return add_moe_aux(model_cfg, loss, stats, aux, "loss")

        return loss_fn

    def make_experience(self, samples, seq_length: int):
        """Build the training store from raw samples."""
        if isinstance(samples[0], str):
            self.store = PromptPipeline(samples, seq_length, self.tokenizer)
        else:
            dialogs = [tokenize_dialogue(d, self.tokenizer, seq_length) for d in samples]
            self.store = DialogStore(dialogs, self.tokenizer)

    def create_train_dataloader(self, seed_offset: int = 0):
        return self.store.create_loader(
            self.config.train.batch_size, shuffle=True,
            seed=self.config.train.seed + self.iter_count + seed_offset,
        )

    def prepare_learning(self):
        self.train_dataloader = self.create_train_dataloader()
        self.eval_dataloader = self.eval_pipeline.create_loader(self.config.train.batch_size)
        self.n_inner_epochs = 1
        self.total_steps = self.config.train.epochs * len(self.train_dataloader)
        self.total_steps = min(self.total_steps, self.config.train.total_steps)
