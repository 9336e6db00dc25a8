"""Patch samplers: which (shape, patch) pairs a pass visits, in what order
(a copy of ``points2surf_tpu/data/samplers.py``: the same numpy
``RandomState`` streams, so for one seed both packages visit the same
patches in the same order).

Same semantics as the reference's three torch samplers
(source/data_loader.py:71-174), as plain numpy index generators. These run
on the host — index bookkeeping is trivial next to the patch extraction on
the card that they feed.
"""

from __future__ import annotations

import numpy as np


class SequentialPatchSampler:
    """All patches of all shapes, in order (reference data_loader.py:71-85)."""

    def __init__(self, shape_patch_count):
        self.shape_patch_count = list(shape_patch_count)
        self.total_patch_count = sum(self.shape_patch_count)

    def __iter__(self):
        return iter(range(self.total_patch_count))

    def __len__(self):
        return self.total_patch_count


class RandomPatchSampler:
    """Fully random over the dataset, without replacement, capped at
    patches_per_shape per shape in expectation (reference :146-174).

    NOTE (mirrors the reference exactly): the cap only shrinks the *total*
    draw count; individual draws are uniform over all patches.
    """

    def __init__(self, shape_patch_count, patches_per_shape, seed=None,
                 identical_epochs=False):
        self.shape_patch_count = list(shape_patch_count)
        self.patches_per_shape = patches_per_shape
        self.identical_epochs = identical_epochs
        self.seed = seed if seed is not None else np.random.randint(0, 2**31)
        self.rng = np.random.RandomState(self.seed)
        self.total_patch_count = sum(
            min(patches_per_shape, c) for c in self.shape_patch_count
        )

    def __iter__(self):
        if self.identical_epochs:
            self.rng.seed(self.seed)
        return iter(
            self.rng.choice(
                sum(self.shape_patch_count),
                size=self.total_patch_count,
                replace=False,
            )
        )

    def __len__(self):
        return self.total_patch_count


class SequentialShapeRandomPatchSampler:
    """Random patches, but patches of one shape stay consecutive
    (reference :88-143) — the cache/bandwidth-friendly order, and the one
    all paper configs train with. Optionally keeps shape order sequential.
    """

    def __init__(self, shape_patch_count, patches_per_shape, seed=None,
                 sequential_shapes=False, identical_epochs=False):
        self.shape_patch_count = list(shape_patch_count)
        self.patches_per_shape = patches_per_shape
        self.sequential_shapes = sequential_shapes
        self.identical_epochs = identical_epochs
        self.seed = seed if seed is not None else np.random.randint(0, 2**31)
        self.rng = np.random.RandomState(self.seed)
        self.total_patch_count = sum(
            min(patches_per_shape, c) for c in self.shape_patch_count
        )
        self.shape_patch_inds: list[np.ndarray] = []

    def __iter__(self):
        if self.identical_epochs:
            self.rng.seed(self.seed)
        offsets = np.concatenate([[0], np.cumsum(self.shape_patch_count)[:-1]])
        shape_inds = np.arange(len(self.shape_patch_count))
        if not self.sequential_shapes:
            shape_inds = self.rng.permutation(shape_inds)
        order = []
        self.shape_patch_inds = [np.array([], int)] * len(self.shape_patch_count)
        for si in shape_inds:
            count = self.shape_patch_count[si]
            take = min(self.patches_per_shape, count)
            picks = self.rng.choice(
                np.arange(offsets[si], offsets[si] + count),
                size=take,
                replace=False,
            )
            order.append(picks)
            self.shape_patch_inds[si] = picks - offsets[si]
        return iter(np.concatenate(order))

    def __len__(self):
        return self.total_patch_count
