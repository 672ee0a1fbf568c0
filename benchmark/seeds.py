"""Seeds for every draw of a run, derived from ``--seed`` and a purpose.

``--seed`` may be any non-negative whole number, wider than 32 bits. Each
purpose ("weights", "frames", "mask", with an index where there are many)
gets its own stream, so one draw never shifts another, and the plain
reference redraws exactly what the program was given.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def derive(seed: int, tag: str, *index: int) -> int:
    """A 63-bit seed for ``(seed, tag, *index)``."""
    if seed < 0:
        raise ValueError(f"--seed must be a non-negative whole number, got {seed}")
    words = [seed & 0xFFFFFFFF, seed >> 32, zlib.crc32(tag.encode()), *index]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32)


def torch_generator(seed: int, tag: str, device, *index: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded for this purpose."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag, *index))
    return g


def numpy_rng(seed: int, tag: str, *index: int) -> np.random.Generator:
    """A NumPy generator seeded for this purpose (host-side draws)."""
    return np.random.default_rng(derive(seed, tag, *index))
