"""Incremental mapping pipeline: colored points + posed images -> 3DGS map
(port of gslivm_tpu/pipeline.py).

The device-side loop corresponding to the reference's `optimize_vis`
training thread plus `gsPointCloudUpdate` (src/liw/lioOptimization.cpp:
1201-1316, 1492-1847), decoupled from ROS/ESIKF: the front end (or a
dataset reader) feeds (points_world, image, camera) frames.

Per frame (gsPointCloudUpdate):
  1. GpMap.divide_points: voxel bookkeeping + PCA surface test (host)
  2. gp_forward: batched voxel GP regression (device)
  3. colorize: project the pooled GP gaussians into the frame image
  4. append to the GaussianParams model (+ hash->index registry), growing
     the capacity by doubling as needed, with the Adam moments padded
  5. collect loss anchors (converged-cell hits + reopened-voxel GP samples)

Training (optimize_vis): keyframe gating by pose delta
(compareStatesImageAdd, lioOptimization.cpp:1181-1199), sliding-window
camera sampling (get_random_indices:1860-1913), train_step with image +
simi + delta-depth losses, budget feedback and pruning.

Where the port differs from the JAX mapper:
  - no jit wrappers and no bucket padding of the colorize and append
    batches: torch does not recompile per shape, and masked rows change no
    result;
  - the tile budgets are fitted when the port's tile backend renders
    (`_resolve_backend(...) == "tiles"`, where the JAX mapper checks
    "pallas"), and the `grad_capacity` fit and its reset on escalation are
    left out: the port's K2 sums the gradient per gaussian itself, so its
    RasterizeSettings has no such field;
  - parameters and Adam state are updated in place (train_step, growth,
    compaction), so the optimizer always holds the module's own Parameters.

Host reads are kept as few as in the JAX mapper: one read of the GP
outputs and one of the colorize outputs per frame, one packed read per
budget-feedback batch, none per training iteration.

On the card's tile path a training iteration's renders, losses and
backward are replayed from one CUDA graph (`training.StepGraph`), the
port's counterpart of the JAX step's compiled executable: it is captured
at the second iteration with a new key (`training.step_key`) and replayed
while the key holds; Adam runs eagerly after it.
"""

from __future__ import annotations

import queue as _queue
import threading
import time as _time
from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .config import Config
from .frontend.gpmap import GpMap
from .models import gaussian_model as gm
from .models import training
from .models.cameras import Camera
from .ops import gp3d
from .ops import losses as loss_ops
from .ops.rasterize import RasterizeSettings, _resolve_backend
from .utils import timer
from .utils.device import resolve_device


def _to_host(*tensors) -> list[np.ndarray]:
    """Copy several device tensors to the host with ONE wait: every copy is
    queued first, then the stream is synchronised once."""
    host = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in host]


class Frame(NamedTuple):
    """One synchronized rendering frame from the front end."""

    points_world: np.ndarray      # [N, 3] new colored map points
    image: np.ndarray             # [H, W, 3] RGB uint8
    camera: Camera                # posed camera for this frame
    cam_projection: gp3d.CameraProjection  # world->cam for colorization


class IncrementalMapper:
    def __init__(
        self,
        config: Config = Config(),
        initial_capacity: int = 2**14,
        settings: RasterizeSettings = RasterizeSettings(),
        bootstrap_points: int = 1000,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = config
        self.settings = settings
        self.bootstrap_points = bootstrap_points
        self.gpmap = GpMap(config.gp, device=self.device)
        self.registry = gm.HashIndexRegistry()
        self.params = gm.create_empty(initial_capacity, config.model.sh_degree,
                                      device=self.device)
        self.optimizer = training.make_optimizer(self.params, config.gs)
        self.started = False
        self.iter = 0
        # the explicit generator of camera sampling: the same seed draws
        # the same cameras as the JAX mapper
        self.rng = np.random.default_rng(seed)

        self.cameras: list[Camera] = []
        self.gt_images: list[np.ndarray] = []
        self._gt_device: list[torch.Tensor] = []  # device-staged GT images
        # per-keyframe (mu2, sigma2_sq) SSIM reference stats, on the device
        self._gt_stats: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._last_key_pose: tuple[np.ndarray, np.ndarray] | None = None
        # round-robin visited sets (selected_indices_curr/_hist,
        # lioOptimization.cpp:1571-1590)
        self._used_curr: set[int] = set()
        self._used_hist: set[int] = set()

        # binning-overflow watchdog (the CUDA rasterizer's buffer resize
        # callback, rasterize_points.cu:36-44): on a sustained overflow
        # streak the tile budgets grow, never silent truncation
        self.last_overflow = 0
        self._overflow_streak = 0
        self.overflow_escalations = 0
        # feedback rows read, and those whose render was truncated (binning
        # overflowed): the steps that trained on a truncated render
        self.feedback_steps = 0
        self.truncated_steps = 0
        # the step on the card's tile path is replayed from a CUDA graph
        # (training.StepGraph): iterations that ran eagerly (the first at
        # each new key, and every one elsewhere), graphs captured, and
        # iterations replayed
        self._graph = training.StepGraph()
        self.eager_steps = 0
        self.graph_captures = 0
        self.graph_replays = 0
        # feedback budget fit (the analog of CUDA's exact num_rendered
        # allocation, rasterizer_impl.cu:277): once the measured expansion
        # is known the loose default budgets shrink to the scene (+ margin),
        # at most once per budget_fit_window steps
        self.budget_fit_window = 50
        self.budget_refits = 0
        self._fit_inst: list[int] = []
        self._fit_chunks: list[int] = []
        self._overflowed_at = 0  # largest budget that ever overflowed:
        # never shrink back to it (prevents shrink->overflow->double cycles)
        # Budget feedback is read in BATCHES of feedback_interval steps: a
        # read waits for the device, and a read per iteration would
        # serialise host and device; escalation lags by at most
        # 2*feedback_interval iterations.
        self.feedback_interval = 8
        self._pending_feedback: list = []
        self._feedback_hot = True  # per-step feedback while budgets are
        # unproven (startup) or known-broken (overflow); the first CLEAN
        # step switches to batched mode

        # loss anchors: voxel hash -> [k, 3] points (latest wins, like the
        # reference's GsForLosses merge, lioOptimization.cpp:459-476)
        self.loss_anchors: dict[int, np.ndarray] = {}
        # deferred-colorization pool: voxel hash -> [means [16,3],
        # covs [16,3,3], age, still-pending mask [16]] for GP voxels no
        # camera has fully seen yet (GpParams.pending_colorize_max_age)
        self._pending_color: dict[int, list] = {}
        # SimiInputs are cached between train iterations: the anchor ->
        # gaussian join is a Python loop over thousands of voxels whose
        # inputs change only in add_frame and prune_map
        self._simi_cache: training.SimiInputs | None = None
        # host seconds of the last add_frame by stage (divide, gp, colorize,
        # append, stage); device work that a stage queues without reading
        # back lands in the next stage that reads
        self.ingest_seconds: dict[str, float] = {}

        self._bg = torch.ones(3, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    # Map growth (gsPointCloudUpdate)
    # ------------------------------------------------------------------

    def add_frame(self, frame: Frame) -> dict:
        secs: dict[str, float] = {}
        with timer.span("ingest"):
            with timer.span("ingest.divide", secs):
                div = self.gpmap.divide_points(frame.points_world)
            with timer.span("ingest.gp", secs):
                error = self._gp_ingest(div)
            with timer.span("ingest.colorize", secs):
                new = self._colorize_pool(frame)
            with timer.span("ingest.append", secs):
                inserted = self._append(*new)
            with timer.span("ingest.stage", secs):
                active = self._stage_keyframe(frame)
        self.ingest_seconds = secs
        return {
            "inserted": inserted,
            "active": active,
            "voxels": self.gpmap.stats(),
            "keyframes": len(self.cameras),
            "overflow_gp": int(error.sum()),
            "pending_color": len(self._pending_color),
        }

    def _gp_ingest(self, div) -> np.ndarray:
        """The GP over the divided batch: loss anchors and the pending
        colorization pool. Returns the per-voxel GP error flags."""
        res = gp3d.gp_forward(div.batch, self.cfg.gp)
        # ONE wait for every GP output the host consumes
        means, covs, reopen, error, upd_var, lp, bmask = _to_host(
            res.means, res.covs, res.reopen, res.error, res.update_variance,
            res.loss_points, div.batch.mask)
        self.gpmap.update_variance(div.hashes, reopen, upd_var)

        vmask = bmask & ~error

        # converged-cell LiDAR hits -> loss anchors (map.cpp:17-25)
        for h in np.unique(div.loss_hashes):
            pts = div.loss_points[div.loss_hashes == h]
            self.loss_anchors[int(h)] = pts
        # reopened-voxel GP samples -> loss anchors (gpprocess.cu:783-800)
        for i in np.nonzero(reopen & vmask)[0]:
            self.loss_anchors[int(div.hashes[i])] = lp[i]

        # queue fresh GP voxels into the deferred-colorization pool (latest
        # GP result wins for a reopened-while-pending voxel); registry
        # membership is the added_final_gs_sample dedup (gpprocess.cu:806-812)
        for i in np.nonzero(vmask)[0]:
            h = int(div.hashes[i])
            # once any subset is inserted the voxel is registered and its
            # remaining pool entry keeps ITS generation (no mixing)
            if self.registry.lookup(h) is None:
                self._pending_color[h] = [
                    means[i], covs[i], 0,
                    np.ones(means.shape[1], bool)]  # gaussians still pending
        return error

    def _colorize_pool(self, frame: Frame):
        """Colorize the ENTIRE pool against this frame in one batched call;
        returns the voxels visible now (xyz, rgb, cov lists and (hash,
        count) ranges) and keeps the unseen remainder until its age cap
        (GpParams.pending_colorize_max_age, the documented deviation from
        the reference's insert-once)."""
        new_xyz, new_rgb, new_cov, ranges = [], [], [], []
        max_age = self.cfg.gp.pending_colorize_max_age
        if self._pending_color:
            keys = list(self._pending_color)
            pm = np.stack([self._pending_color[h][0] for h in keys])
            image = torch.as_tensor(np.asarray(frame.image)).to(self.device)
            pc_dev, pv_dev = gp3d.colorize(
                torch.from_numpy(np.ascontiguousarray(pm, np.float32)).to(self.device),
                frame.cam_projection, image)
            pcolors, pvalid = _to_host(pc_dev, pv_dev)
            strict = max_age < 0
            for j, h in enumerate(keys):
                entry = self._pending_color[h]
                keep = pvalid[j] & entry[3]
                cnt = int(keep.sum())
                if cnt > 0:
                    # insert the newly-visible subset NOW (reference
                    # timing, gpprocess.cu:828-838) ...
                    new_xyz.append(pm[j][keep])
                    new_rgb.append(pcolors[j][keep])
                    new_cov.append(entry[1][keep])
                    ranges.append((h, cnt))
                    entry[3] = entry[3] & ~keep
                # ... and keep the still-unseen remainder pending until a
                # camera sees it or the age cap expires
                entry[2] += 1
                if strict or not entry[3].any() or entry[2] > max(max_age, 0):
                    del self._pending_color[h]
        return new_xyz, new_rgb, new_cov, ranges

    def _append(self, new_xyz, new_rgb, new_cov, ranges) -> int:
        """Append the colorized gaussians (growing the capacity and Adam's
        state) and register their voxel ranges; returns how many."""
        if not new_xyz:
            return 0
        xyz = np.concatenate(new_xyz)
        m = xyz.shape[0]
        start = int(self.params.n_active)
        old_cap = self.params.capacity
        gm.ensure_capacity(self.params, m)
        if self.params.capacity != old_cap:
            training.grow_opt_state(self.optimizer, old_cap, self.params.capacity)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

        batch = gm.PointBatch(
            xyz=dev(xyz), rgb=dev(np.concatenate(new_rgb)),
            cov=dev(np.concatenate(new_cov)),
            mask=torch.ones(m, dtype=torch.bool, device=self.device))
        gm.append_points(self.params, batch, self.cfg.gs.scale_factor)
        for h, cnt in ranges:
            if not self.registry.insert(h, start, cnt):
                # deferred completion of a partially-inserted voxel
                self.registry.append_range(h, start, cnt)
            start += cnt
        return m

    def _stage_keyframe(self, frame: Frame) -> int:
        """Keyframe gating (compareStatesImageAdd, thresholds map_options)
        and the start of training; returns the active gaussians."""
        if self._is_keyframe(frame.camera):
            self.cameras.append(frame.camera)
            gt = np.asarray(frame.image, np.float32).transpose(2, 0, 1) / 255.0
            self.gt_images.append(gt)
            # stage the GT image on the device now, so that training
            # iterations stack device-resident images, and its GT-side SSIM
            # statistics (constant per keyframe: each iteration touching it
            # then skips 2 of its 5 SSIM blur sweeps)
            gt_dev = torch.from_numpy(gt).to(self.device)
            self._gt_device.append(gt_dev)
            with torch.no_grad():
                self._gt_stats.append(loss_ops.ssim_ref_stats(gt_dev))

        active = int(self.params.n_active)
        if not self.started and active > self.bootstrap_points:
            self.started = True  # is_gs_started (lioOptimization.cpp:1426-1443)

        self._simi_cache = None  # anchors and/or registry changed
        return active

    def _is_keyframe(self, camera: Camera) -> bool:
        R = camera.R_cw.detach().cpu().numpy()
        t = camera.cam_center.detach().cpu().numpy()
        if self._last_key_pose is None:
            self._last_key_pose = (R, t)
            return True
        R0, t0 = self._last_key_pose
        dt = np.linalg.norm(t - t0)
        cos = np.clip((np.trace(R0 @ R.T) - 1.0) / 2.0, -1.0, 1.0)
        dr = np.degrees(np.arccos(cos))
        if dt > self.cfg.map.max_delta_trans or abs(dr) > self.cfg.map.max_delta_degree:
            self._last_key_pose = (R, t)
            return True
        return False

    # ------------------------------------------------------------------
    # Training (optimize_vis)
    # ------------------------------------------------------------------

    def _sample_cameras(self):
        """get_random_indices + exist-list round-robin
        (lioOptimization.cpp:1571-1590, 1860-1913): window cameras not yet
        visited this cycle are drawn in random order; when every window
        camera has been visited the visited set resets, so between
        keyframes EVERY window camera is optimized before any repeats.
        History cameras round-robin the same way, paired with their +1
        neighbor for delta-depth."""
        n = len(self.cameras)
        win = self.cfg.gp.image_sliding_window
        split = max(0, n - win)
        curr: list[int] = []
        if win > 0 and self.cfg.gp.curr_cam_per_iter > 0 and n > split:
            cands = [i for i in range(split, n) if i not in self._used_curr]
            if not cands:  # window exhausted -> new cycle
                self._used_curr.clear()
                cands = list(range(split, n))
            cands = [int(i) for i in self.rng.permutation(cands)]
            curr = cands[: self.cfg.gp.curr_cam_per_iter]
            self._used_curr.update(curr)
        hist_pairs: list[tuple[int, int]] = []
        if split > 1 and self.cfg.gp.history_cam_per_iter > 0:
            cands = [i for i in range(split - 1) if i not in self._used_hist]
            if not cands:
                self._used_hist.clear()
                cands = list(range(split - 1))
            cands = [int(i) for i in self.rng.permutation(cands)]
            for idx in cands[: self.cfg.gp.history_cam_per_iter]:
                hist_pairs.append((idx, idx + 1))
            self._used_hist.update(i for i, _ in hist_pairs)
        return curr, hist_pairs

    def _simi_inputs(self, max_gauss: int = 2048) -> training.SimiInputs:
        """calcSimiLoss input assembly (gaussian.cu:201-228): anchors in
        voxels that exist in the registry + their gaussian indices.
        Cached: add_frame / prune_map invalidate it."""
        if self._simi_cache is not None:
            return self._simi_cache
        pts, gidx = [], []
        npts = 0
        for h, anchor in self.loss_anchors.items():
            rs = self.registry.ranges(h)
            if not rs:
                continue
            if npts < training.MAX_SIMI:
                pts.append(anchor)
                npts += len(anchor)
            for s, c in rs:
                gidx.extend(range(s, s + c))
            if npts >= training.MAX_SIMI and len(gidx) >= max_gauss:
                break  # both fixed-shape caps saturated (MAX_SIMI parity)
        simi = training.empty_simi(max_gauss=max_gauss, device=self.device)
        if pts:
            points = np.concatenate(pts)[: training.MAX_SIMI]
            gidx = np.asarray(gidx[:max_gauss], np.int32)
            simi.points[: len(points)] = torch.from_numpy(
                np.asarray(points, np.float32)).to(self.device)
            simi.point_mask[: len(points)] = True
            simi.gauss_idx[: len(gidx)] = torch.from_numpy(gidx).to(self.device)
            simi.gauss_mask[: len(gidx)] = True
        self._simi_cache = simi
        return simi

    def train_iteration(self) -> training.TrainMetrics | None:
        if not self.started or not self.cameras:
            return None
        with timer.span("train"):
            with timer.span("train.sample"):
                curr, hist_pairs = self._sample_cameras()
                cam_idx = curr + [i for pair in hist_pairs for i in pair]
                cams = [self.cameras[i] for i in cam_idx]
                # device-resident GT images: no per-iteration upload
                gts = [self._gt_device[i] for i in cam_idx]
                stats = [self._gt_stats[i] for i in cam_idx]
                simi = self._simi_inputs()
                key = staged = None
                if training.graphable(self.params, self.settings):
                    key = training.step_key(self.params, cams, len(hist_pairs), simi, True,
                                            self.cfg.gs, self.settings, self._bg)
                    staged = self._graph.stage(key, cams, gts, stats, simi)
                if staged is None:
                    gts = torch.stack(gts)
                    gt_stats = (torch.stack([s[0] for s in stats]),
                                torch.stack([s[1] for s in stats]))
            with timer.span("train.step"):
                if staged is None:
                    metrics = training.train_step(
                        self.params, self.optimizer, cams, gts, simi,
                        opt_params=self.cfg.gs, settings=self.settings,
                        n_history_pairs=len(hist_pairs), bg_color=self._bg, gt_stats=gt_stats)
                    self.eager_steps += 1
                else:
                    metrics, captured = self._graph.run(
                        self.params, self.cfg.gs, self.settings, len(hist_pairs), self._bg)
                    training.adam_step(self.optimizer)
                    self.graph_captures += captured
                    self.graph_replays += 1
            self.iter += 1
            with timer.span("train.feedback"):
                self._read_feedback(metrics)
            # pruning lifecycle (completes the reference's never-called
            # prune_optimizer, gaussian.cu:430)
            pi = self.cfg.gs.prune_interval
            if pi > 0 and self.iter % pi == 0:
                with timer.span("train.prune"):
                    self.prune_map()
        return metrics

    def _read_feedback(self, metrics: training.TrainMetrics):
        """Budget feedback is DEFERRED and BATCHED: the metrics of the last
        feedback_interval steps are read together, in ONE packed copy.
        While budgets are known-broken (_feedback_hot) every step is read.
        Every row read is counted (feedback_steps), and those whose binning
        overflowed (truncated_steps), before the budgets take them."""
        self._pending_feedback.append(metrics)
        interval = 1 if self._feedback_hot else self.feedback_interval
        if len(self._pending_feedback) < interval:
            return
        pending, self._pending_feedback = self._pending_feedback, []
        packed = torch.stack([
            torch.stack([m.overflow, m.num_instances, m.max_nchunks])
            for m in pending]).cpu().numpy()
        self.feedback_steps += len(packed)
        self.truncated_steps += int((packed[:, 0] > 0).sum())
        for row in packed:
            esc = self.overflow_escalations
            self._ingest_budget_feedback(*(int(v) for v in row))
            if self.overflow_escalations != esc:
                # the rest of the batch predates the new budgets
                break

    def _ingest_budget_feedback(self, overflow: int, num_instances: int,
                                max_nchunks: int):
        self.last_overflow = overflow
        if overflow > 0:
            self._feedback_hot = True
            self._overflowed_at = max(self._overflowed_at,
                                      self.settings.max_instances)
            self._fit_inst.clear()
            self._fit_chunks.clear()
            self._overflow_streak += 1
            if self._overflow_streak >= 2:
                # the TRUE expansion is measured (num_instances), so jump
                # max_instances straight to it (+20%) instead of doubling
                # blindly; the per-tile chunk cap (whose uncapped need is
                # unobservable) doubles
                b = self._INST_BUCKET
                need_i = int(1.2 * num_instances)
                fitted_i = max(b, -(-need_i // b) * b)
                self.settings = self.settings._replace(
                    max_instances=max(2 * self.settings.max_instances, fitted_i),
                    max_chunks_per_tile=2 * self.settings.max_chunks_per_tile)
                self.overflow_escalations += 1
                self._overflow_streak = 0
        else:
            self._feedback_hot = False
            self._overflow_streak = 0
            self._maybe_shrink_budgets(num_instances, max_nchunks)

    _INST_BUCKET = 512 * 128  # 65,536-slot budget granularity

    def _maybe_shrink_budgets(self, num_instances: int, max_nchunks: int):
        """Shrink max_instances / max_chunks_per_tile toward the measured
        expansion high-water mark (+15% / +2 chunks margin) once a full
        observation window agrees; only when the tile backend renders.
        Growth on overflow is the escalation path above. The JAX mapper
        also takes the walked chunks here, for its grad_capacity fit, which
        the port does not have."""
        if _resolve_backend(self.settings.backend, self.device) != "tiles":
            return
        self._fit_inst.append(num_instances)
        self._fit_chunks.append(max_nchunks)
        if len(self._fit_inst) < self.budget_fit_window:
            return
        b = self._INST_BUCKET
        need_i = int(max(self._fit_inst) * 1.15)
        fitted_i = max(b, -(-need_i // b) * b)
        need_c = max(self._fit_chunks) + 2
        fitted_c = max(8, -(-need_c // 8) * 8)
        new = self.settings
        if fitted_i * 3 // 2 <= new.max_instances and fitted_i > self._overflowed_at:
            new = new._replace(max_instances=fitted_i)
        if fitted_c * 2 <= new.max_chunks_per_tile:
            new = new._replace(max_chunks_per_tile=fitted_c)
        self._fit_inst.clear()
        self._fit_chunks.clear()
        if new != self.settings:
            self.settings = new
            self.budget_refits += 1

    def prune_map(self, min_opacity: float | None = None) -> int:
        """Drop low-opacity (and, when prune_max_scale > 0, runaway-scale)
        gaussians; compact params + Adam state with the same permutation
        and remap the hash->index registry. Returns the number dropped."""
        mo = self.cfg.gs.prune_min_opacity if min_opacity is None else min_opacity
        with torch.no_grad():
            keep = (self.params.get_opacity()[:, 0] >= mo) & self.params.active_mask()
            ms = self.cfg.gs.prune_max_scale
            if ms > 0:
                keep &= self.params.get_scaling().amax(dim=1) <= ms
        keep_host = _to_host(keep)[0]
        dropped = int(self.params.n_active) - int(keep_host.sum())
        if dropped == 0:
            return 0
        order, count = gm.prune_permutation(self.params, keep)
        gm.compact(self.params, order, count)
        training.compact_opt_state(self.optimizer, order, count)
        self.registry.remap_pruned(keep_host)
        self._simi_cache = None  # gaussian indices shifted
        return dropped

    # ------------------------------------------------------------------
    # Outputs (saveRender / Save_ply equivalents)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def render_keyframe(self, index: int):
        return training.render_params(self.params, self.cameras[index], self._bg,
                                      self.settings)

    def save_ply(self, path: str):
        gm.save_ply(self.params, path)

    @torch.no_grad()
    def score_keyframe(self, index: int) -> torch.Tensor:
        """[PSNR, SSIM, mean acc] of keyframe `index`'s render against its
        ground truth, on the device (no host read)."""
        out = self.render_keyframe(index)
        gt = self._gt_device[index]
        return torch.stack([loss_ops.psnr(out.color, gt), loss_ops.ssim(out.color, gt),
                            out.acc.mean()])

    @torch.no_grad()
    def evaluate(self) -> dict:
        """Mean PSNR/SSIM over all keyframes (saveRender,
        lioOptimization.cpp:2198-2234), read back once."""
        pairs = [self.score_keyframe(i) for i in range(len(self.cameras))]
        vals = torch.stack(pairs).cpu().numpy() if pairs else np.zeros((0, 2))
        return {
            "mean_psnr": float(np.mean(vals[:, 0])) if pairs else 0.0,
            "mean_ssim": float(np.mean(vals[:, 1])) if pairs else 0.0,
            "keyframes": len(pairs),
        }


class ConcurrentMapper:
    """Producer/consumer overlap of the host front end and device training.

    The analog of the reference's three-thread topology
    (lioOptimization.cpp:2496-2501: odometry `run`, training `optimize_vis`,
    color staging): the front end (caller's thread) pushes frames into a
    BOUNDED queue and returns to sensor processing at once; a worker thread
    consumes frames (add_frame) and runs `iters_per_frame` training
    iterations per frame. All mapper access is serialized by one lock; the
    overlap win is the host front end running WHILE the device executes
    queued train steps.

    On a card, the worker makes the mapper's device current, and the
    path's kernels (K1, K2, K3) are built and loaded before it starts, so
    no build races the producer.

    Usage:
        cm = ConcurrentMapper(mapper, iters_per_frame=10)
        for frame in frontend:      # front-end thread
            cm.submit_frame(frame)
        mapper = cm.finish()        # drain + join; re-raises worker errors
    """

    KERNELS = ("tile_forward", "tile_backward", "blur")

    def __init__(self, mapper: IncrementalMapper, iters_per_frame: int = 10,
                 queue_size: int = 4, idle_sleep_s: float = 0.002):
        self.mapper = mapper
        self.iters_per_frame = iters_per_frame
        self.idle_sleep_s = idle_sleep_s
        self._queue: _queue.Queue = _queue.Queue(maxsize=queue_size)
        self.lock = threading.Lock()
        # counters are mutated from BOTH threads; a dedicated lock (not
        # self.lock, which is held across whole mapper calls) keeps the
        # read-modify-writes atomic without serializing submit_frame
        # against training
        self._count_lock = threading.Lock()
        self._stop = threading.Event()
        self._outstanding = 0      # frames submitted, not yet mapped
        self._credits = 0          # train iterations owed
        self._error: BaseException | None = None
        self.trained = 0
        self.frames_mapped = 0
        self.busy_s = 0.0  # worker time inside mapper calls: the "serial
        # sum" baseline for the overlap win is frontend_time + busy_s
        self.last_metrics: training.TrainMetrics | None = None
        # the card the worker makes current: "cuda" without an index means
        # the creating thread's current card (a new thread starts on card 0)
        self._card = None
        if mapper.device.type == "cuda":
            self._card = (torch.cuda.current_device() if mapper.device.index is None
                          else mapper.device.index)
            kernels.build(self.KERNELS)
            for name in self.KERNELS:
                kernels.library(name)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="optimize_vis")
        self._thread.start()

    def submit_frame(self, frame: Frame):
        """Enqueue a frame; blocks only when the bounded queue is full
        (back-pressure). The put polls so a worker death surfaces instead
        of deadlocking the producer against a full queue nobody drains."""
        with self._count_lock:
            self._outstanding += 1
        while True:
            if self._error is not None:
                with self._count_lock:
                    self._outstanding -= 1
                raise RuntimeError(
                    "ConcurrentMapper worker died") from self._error
            try:
                self._queue.put(frame, timeout=0.1)
                return
            except _queue.Full:
                continue

    def _run(self):
        try:
            if self._card is not None:
                torch.cuda.set_device(self._card)
            while not self._stop.is_set():
                did_work = False
                try:
                    frame = self._queue.get_nowait()
                except _queue.Empty:
                    frame = None
                if frame is not None:
                    t0 = _time.perf_counter()
                    with self.lock:
                        self.mapper.add_frame(frame)
                    self.busy_s += _time.perf_counter() - t0
                    self.frames_mapped += 1
                    with self._count_lock:
                        self._credits += self.iters_per_frame
                        self._outstanding -= 1
                    did_work = True
                if (self._credits > 0 and self.mapper.started
                        and self.mapper.cameras):
                    t0 = _time.perf_counter()
                    with self.lock:
                        self.last_metrics = self.mapper.train_iteration()
                    self.busy_s += _time.perf_counter() - t0
                    with self._count_lock:
                        self._credits -= 1
                    self.trained += 1
                    did_work = True
                elif self._credits > 0 and not self.mapper.started:
                    with self._count_lock:
                        self._credits = 0  # nothing to train on yet
                if not did_work:
                    _time.sleep(self.idle_sleep_s)
        except BaseException as e:  # surfaced to the producer thread
            self._error = e
            with self._count_lock:
                self._outstanding = 0

    def finish(self) -> IncrementalMapper:
        """Drain the queue and remaining training credits, stop the worker,
        and return the (quiescent) mapper. Re-raises worker exceptions."""
        while (self._outstanding > 0 or self._credits > 0) \
                and self._error is None:
            _time.sleep(0.005)
        self._stop.set()
        self._thread.join()
        if self._error is not None:
            raise RuntimeError("ConcurrentMapper worker died") from self._error
        # quiesce the device: train steps are queued asynchronously, so
        # wall-clock accounting must include the in-flight tail
        if self.mapper.device.type == "cuda":
            torch.cuda.synchronize(self.mapper.device)
        return self.mapper
