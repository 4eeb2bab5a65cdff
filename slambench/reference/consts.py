"""Small constant tensors, built once per device.

``torch.tensor(values, device="cuda")`` copies from pageable host memory:
outside a CUDA graph capture each such copy stalls the host, and inside
one it is not allowed at all. The constants that a step needs (a window's
dims, a grid's origin, the neighbour offsets) are made here once for each
(values, dtype, device) and shared; the values are the same, so the bits
are the same. Callers never write into them.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch

_made: Dict[Tuple, torch.Tensor] = {}


def const(values: Union[float, int, Sequence], dtype: torch.dtype,
          device) -> torch.Tensor:
    """The tensor of ``values`` (a number or a flat sequence) as ``dtype``
    on ``device``, made at its first request and reused after."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (tuple(values) if isinstance(values, (list, tuple)) else values,
           dtype, dev)
    t = _made.get(key)
    if t is None:
        t = torch.tensor(key[0], dtype=dtype, device=dev)
        _made[key] = t
    return t
