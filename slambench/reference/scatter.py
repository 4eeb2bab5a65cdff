"""Deterministic scatter-add of rows: the port's one segment-sum primitive.

``index_put_(accumulate=True)`` sums every contribution to a repeated
index (``x[idx] += v`` keeps one write per index). On CUDA it is
sort-based and free of float atomics, so its result repeats run to run. On
the CPU it is parallel over the contributions and its float sums change
order from run to run, unless PyTorch's deterministic mode is on; there
this helper turns that mode on around the one call, which selects the same
sort-based path.
"""

from __future__ import annotations

import torch


def accumulate_rows(out: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """``out[idx[k]] += vals[k]`` for every k, in place; returns ``out``."""
    if out.device.type != "cpu":
        return out.index_put_((idx,), vals, accumulate=True)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return out.index_put_((idx,), vals, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(prev)
