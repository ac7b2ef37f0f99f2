"""Which outputs of the window are kept for the check, drawn from the seed.

At each position of a batch (frame index modulo the batch) ``per_position``
frames are kept by reservoir sampling, so every frame at that position has
the same chance whatever the window's length, and a fault at any position
of a batch is met.  The driver keeps the last frame as well.  The pipe's
sink draws the config switches whose frames it keeps the same way, one
position, from a stream of its own (``key``).  Numpy only: the sink
process uses it.
"""

from __future__ import annotations

import numpy as np


class Sampler:
    def __init__(self, seed: int, positions: int, per_position: int,
                 key: int = 0x5A3):
        self.rng = np.random.default_rng([seed % (1 << 64), key])
        self.per = per_position
        self.seen = [0] * positions
        self.kept: dict[int, int] = {}     # slot -> frame index

    @property
    def slots(self) -> int:
        return len(self.seen) * self.per

    def offer(self, n: int, position: int) -> int | None:
        """The slot frame ``n`` (at ``position``) is to be kept in, or
        None.  The caller copies the frame into that slot."""
        self.seen[position] += 1
        j = self.seen[position]
        r = j - 1 if j <= self.per else int(self.rng.integers(0, j))
        if r >= self.per:
            return None
        slot = position * self.per + r
        self.kept[slot] = n
        return slot
