"""Name-keyed lookup of registered trainers and pipelines (port of the JAX
package's `utils/loading.py`). Importing this module registers every
ported trainer and pipeline."""

from trlx_tpu_torch.pipeline import _DATAPIPELINE
from trlx_tpu_torch.pipeline import offline_pipeline  # noqa: F401  (registers PromptPipeline)
from trlx_tpu_torch.trainer import _TRAINERS
from trlx_tpu_torch.trainer import bon_trainer  # noqa: F401  (registers BestOfNTrainer)
from trlx_tpu_torch.trainer import grpo_trainer  # noqa: F401  (registers GRPOTrainer)
from trlx_tpu_torch.trainer import ilql_trainer  # noqa: F401  (registers ILQLTrainer)
from trlx_tpu_torch.trainer import ppo_trainer  # noqa: F401  (registers PPOTrainer)
from trlx_tpu_torch.trainer import rft_trainer  # noqa: F401  (registers RFTTrainer)
from trlx_tpu_torch.trainer import sft_trainer  # noqa: F401  (registers SFTTrainer)

# the reference's trainer names, so user configs carry over
_ALIASES = {"acceleratesfttrainer": "sfttrainer", "nemosfttrainer": "sfttrainer",
            "accelerateppotrainer": "ppotrainer", "nemoppotrainer": "ppotrainer",
            "accelerateilqltrainer": "ilqltrainer", "nemoilqltrainer": "ilqltrainer",
            "acceleraterfttrainer": "rfttrainer"}


def get_trainer(name: str):
    """Return the constructor for a registered trainer."""
    name = _ALIASES.get(name.lower(), name.lower())
    if name in _TRAINERS:
        return _TRAINERS[name]
    raise ValueError(
        f"Trainer '{name}' is not registered (ported: {sorted(_TRAINERS)}; the other "
        "methods are ROADMAP queue A, item 4)"
    )


def get_pipeline(name: str):
    """Return the constructor for a registered pipeline."""
    name = name.lower()
    if name in _DATAPIPELINE:
        return _DATAPIPELINE[name]
    raise ValueError(f"Pipeline '{name}' is not registered. Available: {sorted(_DATAPIPELINE)}")
