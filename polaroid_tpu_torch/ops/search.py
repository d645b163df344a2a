"""Binary search over a sorted column.

The port of the JAX package's `ops/search.py`. There the wrapper picks
between `jnp.searchsorted`'s scan method and a sort-based one that a TPU
runs faster; on the card `torch.searchsorted` is one kernel launch, so
the wrapper keeps only the call. Its callers (the as-of join, the
inequality join and `search_sorted`) read as they do in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["searchsorted"]


def searchsorted(a: torch.Tensor, v: torch.Tensor, side: str = "left"
                 ) -> torch.Tensor:
    """Insertion points (int64) of `v` in the ascending `a`: the first
    position whose value is >= v ("left") or > v ("right")."""
    return torch.searchsorted(a, v.contiguous(), side=side)
