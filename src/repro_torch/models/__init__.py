from repro_torch.models.classifiers import (
    LSTMClassifier,
    LSTMClassifierConfig,
    MLPClassifier,
    MLPClassifierConfig,
    accuracy,
    masked_cross_entropy_loss,
)

__all__ = [
    "LSTMClassifier",
    "LSTMClassifierConfig",
    "MLPClassifier",
    "MLPClassifierConfig",
    "accuracy",
    "masked_cross_entropy_loss",
]
