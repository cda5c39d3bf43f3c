from .common import get_initializer
from .extractors import (
    DEFAULT_KEY_EXTRACTORS,
    EXTRACTOR_ALIASES,
    MLP,
    GRUCell,
    ImageCNN,
    MultiInputExtractor,
    resolve_activation,
    resolve_extractor,
)
from .networks import (
    LOG_STD_MAX,
    LOG_STD_MIN,
    Actor,
    RecurrentActor,
    gaussian_entropy,
    gaussian_log_prob,
)

__all__ = [
    "get_initializer",
    "resolve_activation",
    "MLP",
    "ImageCNN",
    "GRUCell",
    "DEFAULT_KEY_EXTRACTORS",
    "MultiInputExtractor",
    "EXTRACTOR_ALIASES",
    "resolve_extractor",
    "Actor",
    "RecurrentActor",
    "LOG_STD_MIN",
    "LOG_STD_MAX",
    "gaussian_log_prob",
    "gaussian_entropy",
]
