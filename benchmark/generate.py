"""The benchmark's one input generator: every traffic file's inputs are made
here from ``--seed`` and the file's parameters.

Every seed gets the same sizes: a pool of batches of one shape, every row
full.  Bases are drawn on the device, in one call.
"""

from __future__ import annotations

import numpy as np
import torch

XCODE_KEEP = 8  # the xcode's keep bit: the code differs from the one before


def rng_of(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed % (1 << 64))


def draw_pool(seed: int, batches: int, rows: int, length: int, device) -> torch.Tensor:
    """uint8[batches, rows, length] xcodes of uniform ACGT, drawn on
    ``device`` by a generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    codes = torch.randint(0, 4, (batches, rows, length), generator=gen, device=device,
                          dtype=torch.uint8)
    keep = torch.ones_like(codes, dtype=torch.bool)
    keep[..., 1:] = codes[..., 1:] != codes[..., :-1]
    return codes | keep.to(torch.uint8) * XCODE_KEEP
