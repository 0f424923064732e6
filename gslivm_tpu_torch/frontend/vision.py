"""Image-side primitives of the VIO path on tensors: the port's own
versions of the four OpenCV calls of the JAX front end.

The JAX package calls OpenCV on the host (gslivm_tpu/frontend/livo.py:171,
vio.py:268, 277, 301); the card machine has no OpenCV, so the port carries
these itself, written from the algorithms, not from a package of solvers:

  - `rgb_to_gray`: COLOR_RGB2GRAY on uint8 in OpenCV 5's fixed-point form,
    (9798 R + 19235 G + 3735 B + 16384) >> 15, bit for bit (OpenCV 4's
    14-bit weights 4899, 9617, 1868 differ from it by one level in 0.26%
    of all colours).
  - `lk_track`: pyramidal Lucas-Kanade after Bouguet, as calcOpticalFlowPyrLK
    runs it with a 21x21 window, maxLevel 3, 30 iterations or a step of
    0.01 px, and a minimum eigenvalue of 1e-4: the pyramid by pyrDown's
    integer 5x5 Gaussian (reflect-101 borders), Scharr derivatives, images
    padded by the window (reflect-101; derivatives with zeros), bilinear
    windows in 14-bit fixed point, and OpenCV's status rules (lost at level
    0 when the window leaves the padded image or the structure tensor is
    too weak). The sums run in float64 where OpenCV sums floats in SIMD
    lanes, so positions may differ from OpenCV's by rounding.
  - `fundamental_ransac`: RANSAC over normalised 8-point fundamental
    matrices; a point is an inlier when its larger squared distance to the
    two epipolar lines is within threshold^2 (OpenCV's error), and the
    iteration count adapts to the confidence. The best hypothesis is
    refitted on its inliers while that grows the set.
  - `pnp_ransac`: RANSAC over Grunert's three-point pose, the fourth point
    of each sample choosing among the quartic's roots; a point is an
    inlier when it reprojects within the threshold in pixels.

Every function takes tensors on any device and returns tensors on it; the
random draws come from the caller's `torch.Generator` (on the CPU), so a
seeded front end is deterministic.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LK_WIN = 21
LK_MAX_LEVEL = 3
LK_MAX_ITERS = 30
LK_EPS = 0.01
LK_MIN_EIG = 1e-4
F_MAX_ITERS = 1000  # findFundamentalMat's default
PNP_CONFIDENCE = 0.99  # solvePnPRansac's default
_W_BITS = 14
_FLT_SCALE = 1.0 / (1 << 20)
_FLT_EPSILON = 1.1920928955078125e-07
_BATCH = 64  # RANSAC hypotheses scored together


# ----------------------------------------------------------------- gray


def rgb_to_gray(image) -> torch.Tensor:
    """[H, W, 3] uint8 RGB -> [H, W] uint8, equal to OpenCV 5's
    cv2.COLOR_RGB2GRAY for every colour."""
    x = torch.as_tensor(image).to(torch.int32)
    return ((9798 * x[..., 0] + 19235 * x[..., 1] + 3735 * x[..., 2] + 16384)
            >> 15).to(torch.uint8)


# ------------------------------------------------------------------- LK


def _reflect101(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect-101 border indices (OpenCV's BORDER_DEFAULT) into [0, n)."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = idx.abs() % period
    return torch.where(idx >= n, period - idx, idx)


# The integer filters below run as float32 convolutions: every partial sum
# is an integer below 2^24, so float32 holds it exactly in any order.
_PYR_TAPS = (1.0, 4.0, 6.0, 4.0, 1.0)
_SCHARR = (((-3.0, 0.0, 3.0), (-10.0, 0.0, 10.0), (-3.0, 0.0, 3.0)),
           ((-3.0, -10.0, -3.0), (0.0, 0.0, 0.0), (3.0, 10.0, 3.0)))


def _pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown of an int32 image holding uint8 values, bit for bit:
    the 5-tap binomial both ways at every other pixel, reflect-101 borders,
    (sum + 128) >> 8. Needs both sides >= 3."""
    k = torch.tensor(_PYR_TAPS, device=img.device)
    x = F.pad(img.to(torch.float32)[None, None], (2, 2, 2, 2), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, 1, 5), stride=(1, 2))
    x = F.conv2d(x, k.view(1, 1, 5, 1), stride=(2, 1))
    return (x[0, 0].to(torch.int32) + 128) >> 8


def _scharr(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's calcScharrDeriv: [h, w, 2] int32 (d/dx, d/dy), reflect-101
    borders. Needs both sides >= 2."""
    k = torch.tensor(_SCHARR, device=img.device)[:, None]
    x = F.pad(img.to(torch.float32)[None, None], (1, 1, 1, 1), mode="reflect")
    return F.conv2d(x, k)[0].permute(1, 2, 0).to(torch.int32)


def _pyramid(gray: torch.Tensor) -> list[torch.Tensor]:
    """buildOpticalFlowPyramid's levels (int32): it stops early once the
    next level would be no larger than the window."""
    levels = [gray.to(torch.int32)]
    for _ in range(LK_MAX_LEVEL):
        h, w = levels[-1].shape
        if (w + 1) // 2 <= LK_WIN or (h + 1) // 2 <= LK_WIN:
            break
        levels.append(_pyr_down(levels[-1]))
    return levels


def _pad_image(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    ry = _reflect101(torch.arange(-LK_WIN, h + LK_WIN, device=img.device), h)
    rx = _reflect101(torch.arange(-LK_WIN, w + LK_WIN, device=img.device), w)
    return img[ry][:, rx]


def _bilinear_weights(frac: torch.Tensor) -> torch.Tensor:
    """[N, 4] int32 fixed-point weights (iw00, iw01, iw10, iw11) from the
    fractional parts [N, 2] (x, y) in float32, as OpenCV rounds them."""
    a, b = frac[:, 0], frac[:, 1]
    one = 1 << _W_BITS
    w00 = torch.round((1.0 - a) * (1.0 - b) * one).to(torch.int32)
    w01 = torch.round(a * (1.0 - b) * one).to(torch.int32)
    w10 = torch.round((1.0 - a) * b * one).to(torch.int32)
    return torch.stack([w00, w01, w10, one - w00 - w01 - w10], dim=1)


def _window(padded: torch.Tensor, corner: torch.Tensor, weights: torch.Tensor,
            shift: int) -> torch.Tensor:
    """The bilinear 21x21 windows whose top-left pixels are `corner` [N, 2]
    (x, y, unpadded coordinates): sum of the four taps times the weights,
    descaled by `shift` bits. padded is [H+2W, W+2W] or [.., .., 2]."""
    ar = torch.arange(LK_WIN + 1, device=padded.device)
    ys = corner[:, 1, None] + LK_WIN + ar          # [N, 22]
    xs = corner[:, 0, None] + LK_WIN + ar
    block = padded[ys[:, :, None], xs[:, None, :]]  # [N, 22, 22(, 2)]
    w = weights.view(-1, 4, *([1] * (block.dim() - 1)))
    s = (block[:, :-1, :-1] * w[:, 0] + block[:, :-1, 1:] * w[:, 1]
         + block[:, 1:, :-1] * w[:, 2] + block[:, 1:, 1:] * w[:, 3])
    return (s + (1 << (shift - 1))) >> shift


def lk_track(prev_gray, next_gray, prev_pts):
    """calcOpticalFlowPyrLK(prev, next, pts, None, winSize=(21, 21),
    maxLevel=3) with OpenCV's default criteria and threshold.

    prev_gray, next_gray: [H, W] uint8 tensors; prev_pts: [N, 2] (x, y).
    Returns (next_pts [N, 2] float32, status [N] bool)."""
    dev = prev_pts.device if torch.is_tensor(prev_pts) else torch.device("cpu")
    prev_pts = torch.as_tensor(prev_pts, dtype=torch.float32, device=dev).reshape(-1, 2)
    n = prev_pts.shape[0]
    status = torch.ones(n, dtype=torch.bool, device=dev)
    next_pts = prev_pts.clone()
    if n == 0:
        return next_pts, status
    prev_pyr = _pyramid(torch.as_tensor(prev_gray, device=dev))
    next_pyr = _pyramid(torch.as_tensor(next_gray, device=dev))
    top = len(prev_pyr) - 1
    half = (LK_WIN - 1) * 0.5
    area = LK_WIN * LK_WIN
    for level in range(top, -1, -1):
        img = prev_pyr[level]
        h, w = img.shape
        i_pad, j_pad = _pad_image(img), _pad_image(next_pyr[level])
        d_pad = F.pad(_scharr(img).permute(2, 0, 1), (LK_WIN,) * 4).permute(1, 2, 0)

        prev = prev_pts * torch.tensor(1.0 / (1 << level), dtype=torch.float32)
        nxt = prev.clone() if level == top else next_pts * 2.0
        next_pts = nxt.clone()

        p = prev - half
        ip = torch.floor(p).to(torch.int64)
        act = ((ip[:, 0] >= -LK_WIN) & (ip[:, 0] < w)
               & (ip[:, 1] >= -LK_WIN) & (ip[:, 1] < h))
        if level == 0:
            status &= act
        ip = torch.where(act[:, None], ip, torch.zeros_like(ip))
        wts = _bilinear_weights(p - ip.to(torch.float32))
        ival = _window(i_pad, ip, wts, _W_BITS - 5).to(torch.float64)   # [N, 21, 21]
        grad = _window(d_pad, ip, wts, _W_BITS).to(torch.float64)      # [N, 21, 21, 2]
        gx, gy = grad[..., 0], grad[..., 1]
        a11 = ((gx * gx).sum((1, 2)) * _FLT_SCALE).to(torch.float32)
        a12 = ((gx * gy).sum((1, 2)) * _FLT_SCALE).to(torch.float32)
        a22 = ((gy * gy).sum((1, 2)) * _FLT_SCALE).to(torch.float32)
        det = a11 * a22 - a12 * a12
        min_eig = (a22 + a11 - torch.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) / (2 * area)
        weak = (min_eig < LK_MIN_EIG) | (det < _FLT_EPSILON)
        if level == 0:
            status &= ~(act & weak)
        run = act & ~weak
        inv_det = 1.0 / torch.where(run, det, torch.ones_like(det))

        # the iterations run on the points still moving (rows `live`)
        live = run.nonzero()[:, 0]
        ival, gx, gy = ival[live], gx[live], gy[live]
        a11, a12, a22, inv_det = a11[live], a12[live], a22[live], inv_det[live]
        pt = nxt[live] - half
        prev_delta = torch.zeros_like(pt)
        for it in range(LK_MAX_ITERS):
            if live.numel() == 0:
                break
            inx = torch.floor(pt).to(torch.int64)
            inside = ((inx[:, 0] >= -LK_WIN) & (inx[:, 0] < w)
                      & (inx[:, 1] >= -LK_WIN) & (inx[:, 1] < h))
            if level == 0:
                status[live[~inside]] = False
            jw = _bilinear_weights(pt - inx.to(torch.float32))
            inx = torch.where(inside[:, None], inx, torch.zeros_like(inx))
            diff = _window(j_pad, inx, jw, _W_BITS - 5).to(torch.float64) - ival
            b1 = ((diff * gx).sum((1, 2)) * _FLT_SCALE).to(torch.float32)
            b2 = ((diff * gy).sum((1, 2)) * _FLT_SCALE).to(torch.float32)
            delta = torch.stack([(a12 * b2 - a22 * b1) * inv_det,
                                 (a12 * b1 - a11 * b2) * inv_det], dim=1)
            pt = pt + delta
            moved = pt + half
            d64 = delta.to(torch.float64)
            converged = (d64 * d64).sum(1) <= LK_EPS * LK_EPS
            swing = (it > 0) & ((delta + prev_delta).abs() < 0.01).all(1)
            moved = torch.where((~converged & swing)[:, None], moved - delta * 0.5, moved)
            next_pts[live[inside]] = moved[inside]
            keep = inside & ~converged & ~swing
            live, pt, prev_delta = live[keep], pt[keep], delta[keep]
            ival, gx, gy = ival[keep], gx[keep], gy[keep]
            a11, a12, a22, inv_det = a11[keep], a12[keep], a22[keep], inv_det[keep]
    return next_pts, status


# ----------------------------------------------------------------- RANSAC


def _ransac_iters(inliers: int, n: int, sample: int, confidence: float,
                  max_iters: int) -> int:
    """RANSACUpdateNumIters: draws for `confidence` of one clean sample."""
    outlier = (n - inliers) / n
    denom = 1.0 - (1.0 - outlier) ** sample
    if denom <= 0.0:
        return 0
    if denom >= 1.0:
        return max_iters
    num = math.log(1.0 - confidence)
    denom = math.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * -denom else round(num / denom)


def _samples(n: int, k: int, count: int, generator) -> torch.Tensor:
    """[count, k] index draws, k distinct indices each."""
    keys = torch.rand(count, n, generator=generator)
    return keys.argsort(dim=1)[:, :k]


def _ransac(n: int, sample: int, score, confidence: float, max_iters: int,
            generator) -> tuple[torch.Tensor | None, object]:
    """Draw hypotheses in batches until the adaptive count is reached; keep
    the first one with the most inliers. `score(idx [B, k])` returns
    (inlier masks [B, n] bool, models). Returns (mask, model) or (None,
    None) when no hypothesis had an inlier."""
    best_mask, best_model, best_count = None, None, 0
    needed, drawn = max_iters, 0
    while drawn < min(needed, max_iters):
        count = min(_BATCH, min(needed, max_iters) - drawn)
        masks, models = score(_samples(n, sample, count, generator))
        counts = masks.sum(1)
        i = int(counts.argmax())
        if int(counts[i]) > best_count:
            best_count, best_mask = int(counts[i]), masks[i].clone()
            best_model = [m[i] for m in models]
            needed = _ransac_iters(best_count, n, sample, confidence, max_iters)
        drawn += count
    return best_mask, best_model


def _normalize(pts: torch.Tensor):
    """Hartley normalisation of [B, k, 2]: (points, T [B, 3, 3])."""
    c = pts.mean(1, keepdim=True)
    d = (pts - c).norm(dim=-1).mean(1).clamp_min(1e-12)
    s = math.sqrt(2.0) / d
    T = torch.zeros(pts.shape[0], 3, 3, dtype=pts.dtype, device=pts.device)
    T[:, 0, 0] = s
    T[:, 1, 1] = s
    T[:, 0, 2] = -s * c[:, 0, 0]
    T[:, 1, 2] = -s * c[:, 0, 1]
    T[:, 2, 2] = 1.0
    return (pts - c) * s[:, None, None], T


def _eight_point(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Fundamental matrices [B, 3, 3] (x2^T F x1 = 0, rank 2) from [B, k, 2]
    correspondences, k >= 8 (least squares for k > 8)."""
    q1, t1 = _normalize(p1)
    q2, t2 = _normalize(p2)
    x1, y1 = q1[..., 0], q1[..., 1]
    x2, y2 = q2[..., 0], q2[..., 1]
    one = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)
    A = torch.cat([A, torch.zeros_like(A[:, :1])], dim=1)  # [B, 9, 9]
    F = torch.linalg.svd(A).Vh[:, -1].reshape(-1, 3, 3)
    U, S, Vh = torch.linalg.svd(F)
    S = S.clone()
    S[:, 2] = 0.0
    F = U @ torch.diag_embed(S) @ Vh
    return t2.transpose(1, 2) @ F @ t1


def _epipolar_error(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """OpenCV's error: the larger squared distance of a point to its
    epipolar line in either image. F [B, 3, 3], x [N, 3] -> [B, N]."""
    l2 = torch.einsum("bij,nj->bni", F, x1)   # lines in image 2
    l1 = torch.einsum("bji,nj->bni", F, x2)   # lines in image 1
    d2 = (l2 * x2).sum(-1)
    d1 = (l1 * x1).sum(-1)
    e2 = d2 * d2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2)
    e1 = d1 * d1 / (l1[..., 0] ** 2 + l1[..., 1] ** 2)
    return torch.maximum(e1, e2)


def fundamental_ransac(pts1, pts2, threshold: float = 3.0, confidence: float = 0.99,
                       generator=None) -> torch.Tensor | None:
    """The inlier mask of findFundamentalMat(pts1, pts2, FM_RANSAC,
    threshold, confidence): [N] bool, or None for fewer than 8 points or no
    consistent hypothesis."""
    p1 = torch.as_tensor(pts1, dtype=torch.float64).reshape(-1, 2)
    p2 = torch.as_tensor(pts2, dtype=torch.float64, device=p1.device).reshape(-1, 2)
    n = p1.shape[0]
    if n < 8:
        return None
    h1 = torch.cat([p1, torch.ones_like(p1[:, :1])], 1)
    h2 = torch.cat([p2, torch.ones_like(p2[:, :1])], 1)
    thr2 = threshold * threshold

    def inliers(F):
        return torch.nan_to_num(_epipolar_error(F, h1, h2), nan=math.inf) <= thr2

    def score(idx):
        idx = idx.to(p1.device)
        F = _eight_point(p1[idx], p2[idx])
        return inliers(F), [F]

    mask, _ = _ransac(n, 8, score, confidence, F_MAX_ITERS, generator)
    # local optimisation: refit on every inlier while the set grows (an
    # 8-point model of noisy points leaves true inliers near the threshold)
    for _ in range(3):
        if mask is None or int(mask.sum()) < 8:
            break
        grown = inliers(_eight_point(p1[mask][None], p2[mask][None]))[0]
        if int(grown.sum()) <= int(mask.sum()):
            break
        mask = grown
    return mask


def _p3p(world: torch.Tensor, rays: torch.Tensor):
    """Grunert's three-point pose. world [B, 3, 3] points, rays [B, 3, 3]
    unit bearings. Returns (R [B, 4, 3, 3], t [B, 4, 3], valid [B, 4]): up
    to four poses per sample, p_cam = R p_world + t."""
    f1, f2, f3 = rays[:, 0], rays[:, 1], rays[:, 2]
    a2 = ((world[:, 1] - world[:, 2]) ** 2).sum(-1)
    b2 = ((world[:, 0] - world[:, 2]) ** 2).sum(-1)
    c2 = ((world[:, 0] - world[:, 1]) ** 2).sum(-1)
    ca, cb, cg = (f2 * f3).sum(-1), (f1 * f3).sum(-1), (f1 * f2).sum(-1)
    amc, apc = (a2 - c2) / b2, (a2 + c2) / b2
    bmc, bma = (b2 - c2) / b2, (b2 - a2) / b2
    A4 = (amc - 1) ** 2 - 4 * c2 / b2 * ca * ca
    A3 = 4 * (amc * (1 - amc) * cb - (1 - apc) * ca * cg + 2 * c2 / b2 * ca * ca * cb)
    A2 = 2 * (amc ** 2 - 1 + 2 * amc ** 2 * cb * cb + 2 * bmc * ca * ca
              - 4 * apc * ca * cb * cg + 2 * bma * cg * cg)
    A1 = 4 * (-amc * (1 + amc) * cb + 2 * a2 / b2 * cg * cg * cb - (1 - apc) * ca * cg)
    A0 = (1 + amc) ** 2 - 4 * a2 / b2 * cg * cg
    B = world.shape[0]
    comp = torch.zeros(B, 4, 4, dtype=world.dtype, device=world.device)
    comp[:, 1:, :3] = torch.eye(3, dtype=world.dtype, device=world.device)
    lead = torch.where(A4.abs() > 1e-12, A4, torch.full_like(A4, 1e-12))
    comp[:, :, 3] = -torch.stack([A0, A1, A2, A3], 1) / lead[:, None]
    finite = torch.isfinite(comp).all(2).all(1)  # a degenerate sample (repeated points)
    comp = torch.where(finite[:, None, None], comp, torch.zeros_like(comp))
    roots = torch.linalg.eigvals(comp)                     # [B, 4] complex
    v = roots.real
    real = roots.imag.abs() <= 1e-6 * (1 + v.abs())
    u = (((-1 + amc[:, None]) * v * v - 2 * amc[:, None] * cb[:, None] * v
          + 1 + amc[:, None]) / (2 * (cg[:, None] - v * ca[:, None])))
    s1 = torch.sqrt((b2[:, None] / (1 + v * v - 2 * v * cb[:, None])).clamp_min(0))
    cam = torch.stack([s1[..., None] * f1[:, None], (u * s1)[..., None] * f2[:, None],
                       (v * s1)[..., None] * f3[:, None]], dim=2)  # [B, 4, 3, 3]
    valid = real & (v > 0) & (u > 0) & finite[:, None] & torch.isfinite(cam).all(-1).all(-1)
    cam = torch.where(valid[..., None, None], cam, torch.zeros_like(cam))
    R, t = _absolute_orientation(world[:, None].expand_as(cam), cam)
    return R, t, valid


def _absolute_orientation(src: torch.Tensor, dst: torch.Tensor):
    """Least-squares rotation and translation (Kabsch), dst ~ R src + t,
    batched over [..., k, 3]."""
    cs, cd = src.mean(-2, keepdim=True), dst.mean(-2, keepdim=True)
    H = (src - cs).transpose(-1, -2) @ (dst - cd)
    U, _, Vh = torch.linalg.svd(H)
    d = torch.det(Vh.transpose(-1, -2) @ U.transpose(-1, -2))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = Vh.transpose(-1, -2) @ D @ U.transpose(-1, -2)
    t = cd.squeeze(-2) - (R @ cs.transpose(-1, -2)).squeeze(-1)
    return R, t


def _reprojection_sq(R, t, world, pixels, K) -> torch.Tensor:
    """Squared pixel error of world points under poses R [..., 3, 3],
    t [..., 3]; inf behind the camera. world [N, 3], pixels [N, 2]."""
    pc = torch.einsum("...ij,nj->...ni", R, world) + t[..., None, :]
    z = pc[..., 2]
    front = z > 1e-9
    z = torch.where(front, z, torch.ones_like(z))
    u = K[0, 0] * pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    err = (u - pixels[:, 0]) ** 2 + (v - pixels[:, 1]) ** 2
    return torch.where(front, torch.nan_to_num(err, nan=math.inf), math.inf)


def pnp_ransac(object_points, image_points, K, reprojection_error: float = 8.0,
               iterations: int = 100, generator=None):
    """solvePnPRansac(obj, img, K, None, reprojectionError, iterationsCount)
    without distortion. Returns (ok, R [3, 3], t [3], inliers [N] bool):
    the pose with the most points reprojecting within the threshold (p_cam
    = R p_world + t) and those points; ok is False when fewer than 4 points
    are given or no hypothesis explains 4 of them."""
    world = torch.as_tensor(object_points, dtype=torch.float64).reshape(-1, 3)
    pix = torch.as_tensor(image_points, dtype=torch.float64, device=world.device).reshape(-1, 2)
    K = torch.as_tensor(K, dtype=torch.float64, device=world.device)
    n = world.shape[0]
    if n < 4:
        return False, None, None, torch.zeros(n, dtype=torch.bool, device=world.device)
    rays = torch.cat([pix, torch.ones_like(pix[:, :1])], 1) @ torch.linalg.inv(K).T
    rays = rays / rays.norm(dim=1, keepdim=True)
    thr2 = reprojection_error * reprojection_error

    def score(idx):
        idx = idx.to(world.device)
        R, t, valid = _p3p(world[idx[:, :3]], rays[idx[:, :3]])
        # the fourth point of the sample picks among the roots
        e4 = _reprojection_sq(R, t, world, pix, K)         # [B, 4, N]
        e4 = e4.gather(2, idx[:, 3, None, None].expand(-1, 4, 1))[..., 0]
        e4 = torch.where(valid, e4, torch.full_like(e4, math.inf))
        pick = e4.argmin(1)
        ar = torch.arange(idx.shape[0], device=world.device)
        R, t = R[ar, pick], t[ar, pick]
        ok = torch.isfinite(e4[ar, pick])
        mask = (_reprojection_sq(R, t, world, pix, K) <= thr2) & ok[:, None]
        return mask, [R, t]

    mask, model = _ransac(n, 4, score, PNP_CONFIDENCE, iterations, generator)
    if mask is None or int(mask.sum()) < 4:
        return False, None, None, torch.zeros(n, dtype=torch.bool, device=world.device)
    return True, model[0], model[1], mask
