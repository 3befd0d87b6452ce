"""pgica_tpu_torch.models subpackage."""
from pgica_tpu_torch.models.presets import LMConfig, ViTConfig, get_text_config, get_vision_config
from pgica_tpu_torch.models.model import (
    PreferenceGuidedCaptioningModel,
    PreferenceGuidedCaptioningModule,
    build_module,
)
