"""Supervised fine-tuning trainer (construction and serving; the CE
training loop comes with the training slice)."""

from dataclasses import dataclass, field

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.base_trainer import TorchTrainer


@dataclass
@register_method
class SFTConfig(MethodConfig):
    """Config for SFT training."""

    gen_kwargs: dict = field(default_factory=dict)


@register_trainer
class SFTTrainer(TorchTrainer):
    def get_arch(self, config: TRLConfig):
        return build_model(
            config.model,
            vocab_size=self.tokenizer.vocab_size,
            seed=config.train.seed,
            device=self.device,
        )
