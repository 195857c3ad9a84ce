from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig
from repro_torch.models.transformer import Transformer
from repro_torch.models.classifiers import (
    LSTMClassifier,
    LSTMClassifierConfig,
    MLPClassifier,
    MLPClassifierConfig,
    accuracy,
    cross_entropy_loss,
    masked_cross_entropy_loss,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "Transformer",
    "LSTMClassifier",
    "LSTMClassifierConfig",
    "MLPClassifier",
    "MLPClassifierConfig",
    "accuracy",
    "cross_entropy_loss",
    "masked_cross_entropy_loss",
]
