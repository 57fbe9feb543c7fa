"""Ordered masked compaction: cumsum for each selected element's slot,
then one scatter per column."""

from __future__ import annotations

from typing import Sequence

import torch


def compact(
    mask: torch.Tensor,
    values: Sequence[torch.Tensor],
    m: int,
    fills: Sequence[int],
):
    """Left-pack ``values[i][b, n]`` where ``mask[b, n]`` into m slots per
    row, in order.

    Returns (list of [B, m] tensors padded with the matching fill, count
    int32[B]).  Elements past m are dropped; the count is the *unclipped*
    number selected, so count > m reveals the loss.
    """
    B = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    count = mask.sum(dim=-1, dtype=torch.int32)
    # Unselected and overflowing elements land in a spare column m.
    dest = torch.where(mask & (rank < m), rank, m)
    outs = []
    for v, fill in zip(values, fills):
        out = torch.full((B, m + 1), fill, dtype=v.dtype, device=v.device)
        out.scatter_(1, dest, v)
        outs.append(out[:, :m])
    return outs, count
