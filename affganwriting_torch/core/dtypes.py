"""Mixed-precision policy: a compute dtype for the convs and matmuls, f32
parameters and statistics.

Port of ``affganwriting_tpu/core/dtypes.py`` with torch dtypes.  The port's
layers keep f32 parameters and compute in the config's ``compute_dtype``
(``models/blocks.py``); normalization statistics, losses and optimizer
state stay in f32.
"""

from __future__ import annotations

import dataclasses

import torch

_NAMES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    compute: str = "bfloat16"
    param: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _NAMES[self.compute]

    @property
    def param_dtype(self) -> torch.dtype:
        return _NAMES[self.param]

    def cast_compute(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.compute_dtype)
