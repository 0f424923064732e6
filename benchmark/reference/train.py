"""The plain reference of the mapper's training iteration, and the
comparison that holds the program's first three iterations of a window to
it.

From a snapshot of the mapper's state (its live parameters, Adam's
moments and step counts, its camera sampler's generator and visited sets,
its LiDAR loss anchors and voxel -> gaussian ranges), the reference works
out again, in float64 and plain torch: which cameras each iteration
draws (a copy of the round-robin of `IncrementalMapper._sample_cameras`),
the structural-loss inputs (a copy of `_simi_inputs`), the renders of
the drawn keyframes (`raster.render`) against their images, the image
loss (1 - l) L1 + l (1 - SSIM), the structural and delta-depth losses,
the gradient (the depth gradient dropped, as the program's rasterizer
contract does), and Adam's update (betas 0.9 / 0.999, eps 1e-15, the
configuration's six learning rates, no schedule). The keyframes' poses
and images are the benchmark's own inputs.
"""

from __future__ import annotations

import statistics
from typing import NamedTuple

import numpy as np
import torch

from . import losses, raster

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
BETAS = (0.9, 0.999)
MAX_SIMI, MAX_GAUSS = 500, 2048


def group_lrs(gs: dict) -> dict:
    """The six groups' learning rates of the configuration's `gs` section
    (feature_rest at feature_lr / 20; spatial_lr_scale 1)."""
    return {"xyz": gs["position_lr_init"], "features_dc": gs["feature_lr"],
            "features_rest": gs["feature_lr"] / 20.0, "scaling": gs["scaling_lr"],
            "rotation": gs["rotation_lr"], "opacity": gs["opacity_lr"]}


class Snapshot(NamedTuple):
    """The mapper's state before the checked iterations (host or device
    tensors; only the first `n` rows are live)."""

    n: int
    params: dict          # leaf name -> tensor [n, ...]
    exp_avg: dict
    exp_avg_sq: dict
    steps: dict           # leaf name -> Adam steps taken
    rng_state: dict       # numpy bit generator state of the camera sampler
    used_curr: set
    used_hist: set
    anchors: list         # [(voxel hash, points [k, 3])] in insertion order
    ranges: dict          # voxel hash -> [(start, count)]
    keyframes: list       # keyframe index -> (R_wc, centre, image uint8)


def sample_cameras(rng, used_curr: set, used_hist: set, n: int, window: int,
                   n_curr: int, n_hist: int):
    """The sliding-window round-robin: window cameras not yet visited this
    cycle in a random order, then history pairs (i, i + 1) likewise."""
    split = max(0, n - window)
    curr = []
    if window > 0 and n_curr > 0 and n > split:
        cands = [i for i in range(split, n) if i not in used_curr]
        if not cands:
            used_curr.clear()
            cands = list(range(split, n))
        cands = [int(i) for i in rng.permutation(cands)]
        curr = cands[:n_curr]
        used_curr.update(curr)
    pairs = []
    if split > 1 and n_hist > 0:
        cands = [i for i in range(split - 1) if i not in used_hist]
        if not cands:
            used_hist.clear()
            cands = list(range(split - 1))
        cands = [int(i) for i in rng.permutation(cands)]
        pairs = [(i, i + 1) for i in cands[:n_hist]]
        used_hist.update(i for i, _ in pairs)
    return curr, pairs


def simi_inputs(anchors, ranges):
    """(points [M, 3], gaussian indices [G]) of the structural loss: the
    anchors of voxels that hold gaussians, both capped."""
    pts, gidx, npts = [], [], 0
    for h, anchor in anchors:
        rs = ranges.get(h)
        if not rs:
            continue
        if npts < MAX_SIMI:
            pts.append(np.asarray(anchor))
            npts += len(anchor)
        for s, c in rs:
            gidx.extend(range(s, s + c))
        if npts >= MAX_SIMI and len(gidx) >= MAX_GAUSS:
            break
    p = np.concatenate(pts)[:MAX_SIMI] if pts else np.zeros((0, 3))
    return p, np.asarray(gidx[:MAX_GAUSS], np.int64)


class StepResult(NamedTuple):
    loss: float
    grad: dict      # leaf -> gradient [n, ...]


def loss_and_grad(p: dict, views, gts, bg, points, gidx, n_pairs: int, gs: dict) -> StepResult:
    """The loss of one iteration at parameters p and its gradient."""
    g = raster.Gaussians(*(p[k].detach().requires_grad_(True) for k in
                           ("xyz", "scaling", "rotation", "opacity")),
                         p["features_dc"][:, 0, :].detach().requires_grad_(True))
    lam = gs["lambda_dssim"]
    total = 0.0
    renders = []
    for v, gt in zip(views, gts):
        r = raster.render(g, v, bg)
        c = r.color.clone().requires_grad_(True)
        loss = (1.0 - lam) * losses.l1(c, gt) + lam * (1.0 - losses.ssim(c, gt))
        (gc,) = torch.autograd.grad(loss, c)
        raster.render(g, v, bg, grad_color=gc)
        total += float(loss.detach())
        renders.append(r)
    s = gs["lambda_depth_simi"] * losses.simi(g.xyz, g.log_scale, points, gidx)
    s.backward()
    total += float(s.detach())
    n = len(views)
    for k in range(n_pairs):
        a = n - 2 * n_pairs + 2 * k
        ra, rb = renders[a], renders[a + 1]
        total += gs["lambda_delta_depth_simi"] * float(
            losses.delta_depth(ra.depth, ra.acc, views[a], rb.depth, rb.acc, views[a + 1]))
    def grad_of(t):
        return torch.zeros_like(t) if t.grad is None else t.grad

    grad = {"xyz": grad_of(g.xyz), "features_dc": grad_of(g.dc)[:, None, :],
            "features_rest": torch.zeros_like(p["features_rest"]),
            "scaling": grad_of(g.log_scale), "rotation": grad_of(g.rotation),
            "opacity": grad_of(g.logit)}
    return StepResult(total, grad)


def adam(p, m, v, steps, grad, lrs):
    """One Adam step of every leaf, in place (torch's arithmetic)."""
    b1, b2 = BETAS
    for k in LEAVES:
        steps[k] += 1
        m[k].mul_(b1).add_(grad[k], alpha=1 - b1)
        v[k].mul_(b2).addcmul_(grad[k], grad[k], value=1 - b2)
        bc1, bc2 = 1 - b1 ** steps[k], 1 - b2 ** steps[k]
        denom = v[k].sqrt() / (bc2 ** 0.5) + 1e-15
        p[k].addcdiv_(m[k], denom, value=-lrs[k] / bc1)


class Followed(NamedTuple):
    losses: list        # the loss of each iteration
    grad1: dict         # the first iteration's gradient by leaf
    change: dict        # parameters after the last iteration less the start


def follow(snap: Snapshot, cfg: dict, iters: int, dtype=torch.float64, device="cpu") -> Followed:
    """The reference's `iters` iterations from the snapshot, in `dtype`."""
    gp, gs, cam = cfg["program"]["gp"], cfg["program"]["gs"], cfg["camera"]
    W, H, fx, fy = cam["width"], cam["height"], cam["fx"], cam["fy"]

    def dev(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype).clone()

    p = {k: dev(snap.params[k]) for k in LEAVES}
    p0 = {k: x.clone() for k, x in p.items()}
    m = {k: dev(snap.exp_avg[k]) for k in LEAVES}
    v = {k: dev(snap.exp_avg_sq[k]) for k in LEAVES}
    steps = dict(snap.steps)
    lrs = group_lrs(gs)
    rng = np.random.default_rng()
    rng.bit_generator.state = snap.rng_state
    used_c, used_h = set(snap.used_curr), set(snap.used_hist)
    pts, gidx = simi_inputs(snap.anchors, snap.ranges)
    points = dev(pts)
    gidx = torch.as_tensor(gidx, device=device)
    bg = torch.ones(3, dtype=dtype, device=device)
    out_losses, grad1 = [], None
    for _ in range(iters):
        curr, pairs = sample_cameras(rng, used_c, used_h, len(snap.keyframes),
                                     gp["image_sliding_window"], gp["curr_cam_per_iter"],
                                     gp["history_cam_per_iter"])
        idx = curr + [i for pr in pairs for i in pr]
        views, gts = [], []
        for i in idx:
            R_wc, c, img = snap.keyframes[i]
            views.append(raster.make_view(R_wc, c, W, H, fx, fy, dtype, device,
                                          cam.get("cx"), cam.get("cy")))
            gts.append(torch.as_tensor(img).to(device=device, dtype=dtype).permute(2, 0, 1) / 255.0)
        res = loss_and_grad(p, views, gts, bg, points, gidx, len(pairs), gs)
        out_losses.append(res.loss)
        if grad1 is None:
            grad1 = res.grad
        with torch.no_grad():
            adam(p, m, v, steps, res.grad, lrs)
    change = {k: p[k] - p0[k] for k in LEAVES}
    return Followed(out_losses, grad1, change)


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_gap(program: dict, reference: dict, ref_grad: dict) -> tuple[float, str]:
    """The worst leaf's |‖program‖ - ‖reference‖| over max(‖reference‖,
    the median leaf's ‖reference‖), over the leaves whose reference
    gradient is at least a thousandth of the median leaf's; (gap, leaf)."""
    gnorm = {k: _norm(ref_grad[k]) for k in LEAVES}
    gmed = statistics.median(gnorm.values())
    keep = [k for k in LEAVES if gnorm[k] >= 1e-3 * gmed]
    rnorm = {k: _norm(reference[k]) for k in keep}
    med = statistics.median(rnorm.values())
    worst, name = 0.0, ""
    for k in keep:
        gap = abs(_norm(program[k]) - rnorm[k]) / max(rnorm[k], med, 1e-300)
        if not np.isfinite(gap):
            gap = float("inf")
        if gap >= worst:
            worst, name = gap, k
    return worst, name


class ProgramRun(NamedTuple):
    """What the program's first iterations produced: each loss, Adam's
    first moment after the first iteration, the parameters after the
    last (live rows)."""

    losses: list
    exp_avg1: dict
    params_after: dict
    overflow: tuple = ()  # instances each iteration's binning dropped (logged)


def compare(snap: Snapshot, prog: ProgramRun, ref: Followed) -> dict:
    """The three numbers the check holds against its limits."""
    b1 = BETAS[0]
    g1 = {k: (prog.exp_avg1[k].double() - b1 * torch.as_tensor(snap.exp_avg[k]).double()
              .to(prog.exp_avg1[k].device)) / (1 - b1) for k in LEAVES}
    ch = {k: prog.params_after[k].double()
          - torch.as_tensor(snap.params[k]).double().to(prog.params_after[k].device)
          for k in LEAVES}
    loss_gap = max(abs(a - b) / max(abs(b), 1e-300) for a, b in zip(prog.losses, ref.losses))
    grad_gap, grad_leaf = leaf_gap(g1, ref.grad1, ref.grad1)
    step_gap, step_leaf = leaf_gap(ch, ref.change, ref.grad1)
    return {"loss_gap": float(loss_gap) if np.isfinite(loss_gap) else float("inf"),
            "grad_gap": grad_gap, "grad_leaf": grad_leaf,
            "step_gap": step_gap, "step_leaf": step_leaf,
            "losses": list(prog.losses), "ref_losses": list(ref.losses),
            "overflow": list(prog.overflow)}
