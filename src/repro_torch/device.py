"""The device the port's entry points run on: CUDA unless the caller asks
for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device`, or CUDA when it is None. Raises when CUDA is asked for
    (or defaulted to) and missing — nothing falls back to the CPU quietly.
    Turns TF32 off: ADC counts round at .5 boundaries, and TF32 matmuls
    would move them."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
