"""Host-side voxel-GP bookkeeping: cells, PCA surface test, batch assembly
(the port's own copy of gslivm_tpu/frontend/gpmap.py; only the batch it
hands to gp3d.gp_forward is built as torch tensors on the map's device).

Behavioral spec: reference `src/gp3d/map.cpp`, `cell.cpp`, `gpmap.h`:
  - spatial hash (gpmap.h:8-15): floor(p/grid) * (73856093, 19349669,
    83492791) summed — computed here in int64 (the reference does the sum in
    double then casts to size_t; for realistic coordinates the values are
    identical).
  - splitPointsIntoCell (map.cpp:7-38): converged cells don't buffer new
    points — the points become loss anchors instead (capped at MAX_SIMI per
    frame); open cells buffer up to 2*min_points points, each carrying
    variance_sensor.
  - Cell PCA (cell.cpp:5-31): surface iff lambda_max/lambda_mid > eigen_1;
    GP direction = axis most aligned with the smallest eigenvector.
  - dividePointsIntoCellInitMap (map.cpp:51-111): updated, unconverged cells
    with >= min_points points become GP work items and are marked converged.
  - updateVariance (map.cpp:39-49): reopened voxels get is_converged=false
    and their variance buffer head overwritten; they are queued for
    reprocessing on the next divide call.
  - GP work items take the LAST min_points buffered points but the FIRST
    min_points variance entries (allocateHostDataGP3D, gpprocess.cu:250-270)
    — a reference quirk reproduced faithfully.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import GpParams
from ..ops.gp3d import GpBatch
from ..utils.device import resolve_device

MAX_SIMI = 500  # gp_types.h:15

_KP = np.asarray([73856093, 19349669, 83492791], dtype=np.int64)


def voxel_hash(ijk: np.ndarray) -> np.ndarray:
    """Spatial hash of integer cell coords [..., 3] -> int64."""
    return (ijk.astype(np.int64) * _KP).sum(axis=-1)


@dataclasses.dataclass
class _Cell:
    ijk: np.ndarray                 # integer cell coords [3]
    points: list                    # buffered points (world, np [3])
    variance: list                  # per-point sensor std
    converged: bool = False


class DivideResult(NamedTuple):
    batch: GpBatch                  # padded GP work batch
    hashes: np.ndarray              # [V] int64 voxel hash per batch row
    loss_points: np.ndarray         # [L, 3] anchors from converged cells
    loss_hashes: np.ndarray         # [L] int64 voxel hash per anchor


class GpMap:
    """Incremental voxel map feeding the batched GP solver; its GP batches
    go to `device`."""

    def __init__(self, cfg: GpParams = GpParams(), device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cells: dict[int, _Cell] = {}
        self._pending: list[int] = []  # reopened voxels to re-process

    def divide_points(self, points_world: np.ndarray) -> DivideResult:
        """splitPointsIntoCell + dividePointsIntoCellInitMap for one frame.

        points_world: [N, 3] float64/float32 colored map points.
        Returns a padded GpBatch (mask marks live rows) plus loss anchors.
        """
        cfg = self.cfg
        pts = np.asarray(points_world, dtype=np.float64)
        ijk = np.floor(pts / cfg.grid).astype(np.int64)
        hashes = voxel_hash(ijk)

        updated: list[int] = list(self._pending)
        self._pending = []
        loss_pts: list[np.ndarray] = []
        loss_hashes: list[int] = []
        cap = 2 * cfg.min_points_num_to_gp

        for p, key3, h in zip(pts, ijk, hashes):
            cell = self.cells.get(h)
            if cell is None:
                cell = _Cell(ijk=key3, points=[], variance=[])
                self.cells[h] = cell
            if cell.converged:
                if len(loss_pts) < MAX_SIMI:
                    loss_pts.append(p)
                    loss_hashes.append(h)
                continue
            if len(cell.points) >= cap:
                continue
            cell.points.append(p)
            cell.variance.append(cfg.variance_sensor)
            updated.append(h)

        # candidate cells -> PCA surface test -> GP work items
        work: list[tuple[int, _Cell, int]] = []
        seen = set()
        for h in updated:
            if h in seen:
                continue
            seen.add(h)
            cell = self.cells.get(h)
            if cell is None or cell.converged or len(cell.points) < cfg.min_points_num_to_gp:
                continue
            direction, is_surface = self._cell_pca(cell)
            if is_surface and direction >= 0:
                work.append((h, cell, direction))
                cell.converged = True

        return self._pack(work, loss_pts, loss_hashes)

    def _cell_pca(self, cell: _Cell) -> tuple[int, bool]:
        """Cell ctor (cell.cpp:5-31): surface test + GP direction."""
        pts = np.asarray(cell.points)
        centroid = pts.mean(axis=0)
        cov = (pts - centroid).T @ (pts - centroid) / pts.shape[0]
        evals, evecs = np.linalg.eigh(cov)  # ascending
        lam_min, lam_mid, lam_max = evals
        if lam_mid <= 0:
            return -1, False
        if lam_max / lam_mid <= self.cfg.eigen_1:
            return -1, False
        v_min = evecs[:, 0]
        angles = np.arccos(np.clip(np.abs(v_min), -1.0, 1.0))
        return int(np.argmin(angles)), True

    def _pack(self, work, loss_pts, loss_hashes) -> DivideResult:
        cfg = self.cfg
        nt = cfg.min_points_num_to_gp
        v = len(work)
        # power-of-two bucketing, as in the JAX package (which bounds its
        # recompiles with it): the same padded batches in both packages
        vpad = 8
        while vpad < v:
            vpad *= 2
        points = np.zeros((vpad, nt, 3), np.float32)
        variance = np.full((vpad, nt), cfg.variance_sensor, np.float32)
        direction = np.zeros((vpad,), np.int32)
        region_min = np.zeros((vpad, 3), np.float32)
        mask = np.zeros((vpad,), bool)
        hashes = np.zeros((vpad,), np.int64)

        for i, (h, cell, d) in enumerate(work):
            # LAST nt points, FIRST nt variances (reference quirk, see doc)
            points[i] = np.asarray(cell.points[-nt:], np.float32)
            variance[i] = np.asarray(cell.variance[:nt], np.float32)
            direction[i] = d
            region_min[i] = cell.ijk * cfg.grid
            mask[i] = True
            hashes[i] = h

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        batch = GpBatch(
            points=dev(points),
            variance=dev(variance),
            direction=dev(direction),
            region_min=dev(region_min),
            mask=dev(mask),
        )
        lp = np.asarray(loss_pts, np.float32).reshape(-1, 3)
        lh = np.asarray(loss_hashes, np.int64)
        return DivideResult(batch=batch, hashes=hashes, loss_points=lp,
                            loss_hashes=lh)

    def update_variance(self, hashes: np.ndarray, reopen_mask: np.ndarray,
                        update_variance: np.ndarray):
        """updateVariance (map.cpp:39-49): reopen flagged voxels and write
        their new per-point variances; queue them for reprocessing."""
        for h, reopen, upd in zip(hashes, reopen_mask, update_variance):
            if not reopen:
                continue
            cell = self.cells.get(int(h))
            if cell is None:
                continue
            cell.converged = False
            n = min(len(cell.variance), len(upd))
            for i in range(n):
                cell.variance[i] = float(upd[i])
            self._pending.append(int(h))

    def stats(self) -> dict:
        converged = sum(1 for c in self.cells.values() if c.converged)
        return {
            "cells": len(self.cells),
            "converged": converged,
            "open": len(self.cells) - converged,
        }
