"""ICP voxel hash map: insertion rules, kNN search, grid sampling.
(the port's own copy of gslivm_tpu/frontend/voxelmap.py; numpy on the host, as there)

Behavioral spec: reference `include/liw/cloudMap.h` (voxel/voxelBlock/
voxelHashMap), `src/liw/lioOptimization.cpp:556-598` (addPointToMap) and
`src/liw/optimize.cpp:353-418` (searchNeighbors), `src/liw/utility.cpp:
172-202` (subSampleFrame/gridSampling):

  - voxel key = trunc(p / voxel_size) per axis (short casts);
  - a voxel holds at most max_num_points_in_voxel points; a new point is
    inserted only if its nearest in-voxel neighbor is farther than
    min_distance_points;
  - kNN: scan the (2r+1)^3 neighbor voxels, keep the max_num_neighbors
    closest (priority queue), skipping voxels under threshold_capacity;
  - grid sampling keeps the first point of each voxel.

numpy implementation with per-voxel contiguous arrays. This is the
latency-critical CPU structure flagged for a C++ port (SURVEY §7: "host-
side C++ where the reference is native C++"); the API is kept flat
(arrays in/arrays out) so the C++ extension can slot in untouched.
"""

from __future__ import annotations

import numpy as np


def voxel_key(points: np.ndarray, size: float) -> np.ndarray:
    """trunc-toward-zero voxel coords (short casts in the reference)."""
    return np.trunc(np.asarray(points) / size).astype(np.int64)


def grid_sample(points: np.ndarray, size: float) -> np.ndarray:
    """subSampleFrame keep-first semantics -> indices of kept points."""
    keys = voxel_key(points, size)
    # first occurrence per voxel, preserving first-seen order is not
    # required (the reference iterates an unordered_map); keep first index.
    _, idx = np.unique(keys, axis=0, return_index=True)
    return np.sort(idx)


class VoxelMap:
    """Geometry map for plane-ICP."""

    def __init__(self, voxel_size: float, max_points: int = 20,
                 min_distance: float = 0.1):
        self.size = voxel_size
        self.max_points = max_points
        self.min_distance = min_distance
        self.voxels: dict[tuple, np.ndarray] = {}

    def __len__(self):
        return sum(len(v) for v in self.voxels.values())

    def add_points(self, points: np.ndarray, min_num_points: int = 0):
        """addPointToMap rules for a batch of world points."""
        keys = voxel_key(points, self.size)
        for p, k in zip(np.asarray(points, np.float64), map(tuple, keys)):
            block = self.voxels.get(k)
            if block is None:
                if min_num_points <= 0:
                    self.voxels[k] = p[None, :].copy()
                continue
            if len(block) >= self.max_points:
                continue
            d2 = ((block - p) ** 2).sum(axis=1).min()
            if d2 > self.min_distance**2:
                if min_num_points <= 0 or len(block) >= min_num_points:
                    self.voxels[k] = np.concatenate([block, p[None, :]])

    def search_neighbors(self, point: np.ndarray, nb_voxels: int,
                         max_neighbors: int, threshold_capacity: int = 1):
        """kNN over the (2r+1)^3 neighborhood; returns [k,3] sorted by
        distance (closest first), possibly empty."""
        k0 = np.trunc(np.asarray(point) / self.size).astype(np.int64)
        cands = []
        rng = range(-nb_voxels, nb_voxels + 1)
        for dx in rng:
            for dy in rng:
                for dz in rng:
                    block = self.voxels.get((k0[0] + dx, k0[1] + dy, k0[2] + dz))
                    if block is None or len(block) < threshold_capacity:
                        continue
                    cands.append(block)
        if not cands:
            return np.zeros((0, 3))
        pts = np.concatenate(cands)
        d = np.linalg.norm(pts - point, axis=1)
        order = np.argsort(d)[:max_neighbors]
        return pts[order]

    def remove_far_voxels(self, center: np.ndarray, max_distance: float):
        """Map pruning by distance (odometry_options.max_distance)."""
        dead = [
            k for k, block in self.voxels.items()
            if np.linalg.norm(block[0] - center) > max_distance
        ]
        for k in dead:
            del self.voxels[k]
