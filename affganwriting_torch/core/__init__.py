from affganwriting_torch.core.config import (
    WordGanConfig,
    VOCAB,
    default_config,
)
from affganwriting_torch.core.dtypes import DtypePolicy

__all__ = ["WordGanConfig", "VOCAB", "default_config", "DtypePolicy"]
