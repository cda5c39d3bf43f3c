"""Scene-path datasets and their round-robin loader (counterpart of
``visfly_tpu/utils/dataloader.py``).

The loader draws its order from Python's ``random.Random(seed)``, as the JAX
package does, so one seed gives the same sequence of scene files in both.
"""
from __future__ import annotations

import glob
import os
import random
from typing import List, Optional


def get_files_with_suffix(root: str, suffix: str) -> List[str]:
    """``root`` itself when it is a file with ``suffix``, else every file
    under it with ``suffix``, recursively and sorted."""
    if os.path.isfile(root):
        return [root] if root.endswith(suffix) else []
    return sorted(glob.glob(os.path.join(root, "**", f"*{suffix}"), recursive=True))


class ChildrenPathDataset:
    """The scene files under ``path``: scene-instance JSONs, else GLB stages,
    else the path itself (a procedural preset's name)."""

    def __init__(self, path: str, shuffle: bool = True, seed: int = 42):
        self.path = path
        self.items: List[str] = (get_files_with_suffix(path, ".scene_instance.json")
                                 or get_files_with_suffix(path, ".glb") or [path])
        self.shuffle = shuffle
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i % len(self.items)]


class SimpleDataLoader:
    """Round-robin batches over a dataset: each ``next(num)`` returns the next
    ``num`` items of a shuffled order, reshuffled at the end of every epoch."""

    def __init__(self, dataset, batch_size: Optional[int] = None, shuffle: bool = True,
                 seed: int = 42):
        self.dataset = dataset
        self.batch = batch_size
        self.shuffle = shuffle
        self._rng = random.Random(seed)
        self._order: List[int] = []
        self._pos = 0
        self._reshuffle()

    def _reshuffle(self):
        self._order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(self._order)
        self._pos = 0

    def next(self, num: Optional[int] = None) -> List:
        num = num if num is not None else (self.batch or 1)
        out = []
        for _ in range(num):
            if self._pos >= len(self._order):
                self._reshuffle()
            out.append(self.dataset[self._order[self._pos]])
            self._pos += 1
        return out
