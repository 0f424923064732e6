"""What the drivers share: the program's configuration from a
configuration file, the camera the mapper trains on, the program's frames
from the generator's, the snapshot of the mapper that the reference
follows, the program's first iterations of a check, the record of each
frame's appended rows and of the GP's centres, and the checks of the
training step and of the ingest."""

from __future__ import annotations

import copy
import time

import torch

from .. import scene
from ..reference import gp as ref_gp
from ..reference import ingest as ref_ingest
from ..reference import train as ref_train


def program_config(cfg: dict):
    """The program's Config: its defaults (basic_common.yaml) under the
    configuration file's `program` overrides."""
    from gslivm_tpu_torch.config import load_config  # noqa: PLC0415

    return load_config(dataset_overrides=cfg["program"])


def mapper(cfg: dict, seed: int, device):
    """The program's IncrementalMapper as the configuration file states it."""
    from gslivm_tpu_torch.pipeline import IncrementalMapper  # noqa: PLC0415

    return IncrementalMapper(program_config(cfg), bootstrap_points=cfg["bootstrap_points"],
                             seed=seed, device=device)


def image_camera(cfg: dict) -> dict:
    """The camera the mapper trains on: the configuration's sensor image
    scaled by its image_resize_ratio as LivoFrontend scales it (sizes
    truncated, focal lengths multiplied); the principal point is centred."""
    cam = cfg["camera"]
    r = float(cam.get("image_resize_ratio", 1.0))
    return {"width": int(cam["image_width"] * r), "height": int(cam["image_height"] * r),
            "fx": cam["fx"] * r, "fy": cam["fy"] * r}


def camera(R_wc, center, cam: dict, device):
    """The program's camera of a pose, its focal from the configuration."""
    from gslivm_tpu_torch.models.cameras import make_camera  # noqa: PLC0415

    return make_camera(R_wc, center, cam["width"], cam["height"], fx=cam["fx"], fy=cam["fy"],
                       device=device)


def frame(mf: scene.MapFrame, cam: dict, device):
    """The program's Frame of a generated frame."""
    from gslivm_tpu_torch.ops.gp3d import CameraProjection  # noqa: PLC0415
    from gslivm_tpu_torch.pipeline import Frame  # noqa: PLC0415

    c = camera(mf.R_wc, mf.center, cam, device)
    proj = CameraProjection(R_wc=c.R_cw, t_wc=c.t_cw, fx=c.K[0, 0], fy=c.K[1, 1],
                            cx=c.K[0, 2], cy=c.K[1, 2], dist=torch.zeros(4, device=c.device))
    return Frame(points_world=mf.points, image=mf.image, camera=c, cam_projection=proj)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class GpLog:
    """While entered, every call of the program's `gp_forward` is counted;
    the first `cap` with a cell in their batch leave a copy of the batch
    and of the centres they produced, and the first `centre_cap` calls the
    centres of their valid cells (in the batch's mask, without error),
    [V * 16, 3]."""

    def __init__(self, cap: int, centre_cap: int):
        self.cap, self.centre_cap = cap, centre_cap
        self.calls, self.centres = [], []
        self.n_calls = 0

    def __enter__(self):
        from gslivm_tpu_torch.ops import gp3d  # noqa: PLC0415

        self._mod, self._fn = gp3d, gp3d.gp_forward

        def logged(batch, cfg, *a, **kw):
            res = self._fn(batch, cfg, *a, **kw)
            self.n_calls += 1
            if len(self.calls) < self.cap and batch.points.shape[0] > 0:
                self.calls.append(tuple(t.detach().clone() for t in (
                    res.means, batch.points, batch.variance, batch.direction,
                    batch.region_min, batch.mask)))
            if self.n_calls <= self.centre_cap:
                ok = batch.mask & ~res.error
                self.centres.append(res.means[ok].detach().reshape(-1, 3).clone())
            return res

        gp3d.gp_forward = logged
        return self

    def __exit__(self, *exc):
        self._mod.gp_forward = self._fn


class AppendLog:
    """The rows each add_frame appended ([start, end) after the call: its
    `active` less its `inserted`), copied on the device at once (a prune
    later moves rows), with the frame's pose and image and the number of
    `gp_forward` calls made by then (the frame's own included)."""

    def __init__(self, cap_frames: int, gplog: GpLog):
        self.cap = cap_frames
        self.gplog = gplog
        self.rows = []

    def add(self, mapper, info: dict, R_wc, center, image):
        if len(self.rows) >= self.cap or info["inserted"] == 0:
            return
        end = info["active"]
        start = end - info["inserted"]
        with torch.no_grad():
            xyz = mapper.params.xyz[start:end].detach().clone()
            dc = mapper.params.features_dc[start:end].detach().clone()
        self.rows.append((xyz, dc, R_wc, center, image, self.gplog.n_calls))


def ingest_numbers(log: AppendLog, fx: float, fy: float, control: bool = False) -> dict:
    """The mean colour gap in 8-bit levels a channel over every logged
    frame's appended rows (for the control, the reference's own colours
    projected in bfloat16 in the program's place)."""
    if not log.rows:
        return {"ingest_colour_gap": float("inf")}
    gap, n = 0.0, 0
    for xyz, dc, R_wc, center, image, _ in log.rows:
        rgb = (ref_ingest.colours(xyz.to(torch.bfloat16), R_wc, center, fx, fy, image)
               if control else ref_ingest.appended_rgb(dc))
        g, m = ref_ingest.colour_gap(xyz, rgb, R_wc, center, fx, fy, image)
        gap += g
        n += 3 * m
    return {"ingest_colour_gap": gap / n}


def append_numbers(log: AppendLog, control: bool = False) -> dict:
    """The appended centres that are not, bit for bit, the centre of a
    valid GP cell of a `gp_forward` call made by their frame, over every
    logged frame whose calls all left their centres (for the control, the
    centres rounded to bfloat16 in the program's place); and how many rows
    were compared."""
    rows = [r for r in log.rows if r[5] <= len(log.gplog.centres)]
    if not rows or not log.gplog.centres:
        return {"append_xyz_unmatched": float("inf"), "append_xyz_rows": 0}
    unmatched, n = 0, 0
    for xyz, _, _, _, _, calls in rows:
        if control:
            xyz = xyz.to(torch.bfloat16).to(xyz.dtype)
        unmatched += ref_ingest.unmatched_rows(xyz, log.gplog.centres[:calls])
        n += int(xyz.shape[0])
    return {"append_xyz_unmatched": unmatched, "append_xyz_rows": n}


def gp_numbers(log: GpLog, gp: dict, control: bool = False) -> dict:
    """The widest gap in mm between the program's GP centres and the
    reference's over every logged batch."""
    gaps = [g for g in (ref_gp.mean_gap_mm(*c, gp, control) for c in log.calls) if g is not None]
    return {"gp_mean_gap_mm": max(gaps) if gaps else float("inf")}


def prune_clear(mapper, k: int):
    """Train until none of the next k iterations prunes (a prune compacts
    the rows the check compares)."""
    pi = mapper.cfg.gs.prune_interval
    while pi > 0 and any((mapper.iter + j) % pi == 0 for j in range(1, k + 1)):
        mapper.train_iteration()


def snapshot(mapper, keyframe_source) -> ref_train.Snapshot:
    """The mapper's state as the reference follows it. keyframe_source(cam)
    gives the benchmark's (R_wc, centre, image) of a keyframe camera."""
    n = int(mapper.params.n_active)
    params, m, v, steps = {}, {}, {}, {}
    for group in mapper.optimizer.param_groups:
        name = group["name"]
        p = group["params"][0]
        st = mapper.optimizer.state.get(p, {})
        params[name] = p.detach()[:n].clone()
        m[name] = (st["exp_avg"][:n].clone() if "exp_avg" in st else torch.zeros_like(params[name]))
        v[name] = (st["exp_avg_sq"][:n].clone() if "exp_avg_sq" in st
                   else torch.zeros_like(params[name]))
        steps[name] = int(st["step"]) if "step" in st else 0
    anchors = list(mapper.loss_anchors.items())
    ranges = {h: list(mapper.registry.ranges(h)) for h, _ in anchors}
    return ref_train.Snapshot(
        n=n, params=params, exp_avg=m, exp_avg_sq=v, steps=steps,
        rng_state=copy.deepcopy(mapper.rng.bit_generator.state),
        used_curr=set(mapper._used_curr), used_hist=set(mapper._used_hist),
        anchors=anchors, ranges=ranges,
        keyframes=[keyframe_source(c) for c in mapper.cameras])


def program_iterations(mapper, k: int) -> ref_train.ProgramRun:
    """The mapper's next k train_iterations (the window's own call), with
    each loss, Adam's first moment after the first and the live parameters
    after the last."""
    n = int(mapper.params.n_active)
    losses, overflow, exp_avg1 = [], [], None
    for i in range(k):
        metrics = mapper.train_iteration()
        losses.append(metrics.loss)
        overflow.append(metrics.overflow)
        if i == 0:
            exp_avg1 = {g["name"]: mapper.optimizer.state[g["params"][0]]["exp_avg"][:n].clone()
                        for g in mapper.optimizer.param_groups}
    after = {g["name"]: g["params"][0].detach()[:n].clone()
             for g in mapper.optimizer.param_groups}
    return ref_train.ProgramRun([float(x) for x in losses], exp_avg1, after,
                                tuple(int(x) for x in overflow))


def train_numbers(snap, prog, cfg: dict, k: int, device, control: bool) -> dict:
    """loss_gap, grad_gap and step_gap of the program's k iterations (or,
    for the control, of the reference in bfloat16) against the float64
    reference from the same snapshot."""
    cfg = dict(cfg, camera=image_camera(cfg))
    ref = ref_train.follow(snap, cfg, k, torch.float64, device)
    if control:
        low = ref_train.follow(snap, cfg, k, torch.bfloat16, device)
        b1 = ref_train.BETAS[0]
        exp_avg1 = {name: b1 * torch.as_tensor(snap.exp_avg[name]).to(device).double()
                    + (1 - b1) * low.grad1[name].double() for name in ref_train.LEAVES}
        after = {name: torch.as_tensor(snap.params[name]).to(device).double()
                 + low.change[name].double() for name in ref_train.LEAVES}
        prog = ref_train.ProgramRun(low.losses, exp_avg1, after)
    return ref_train.compare(snap, prog, ref)


def checks(numbers: dict, limits: dict) -> list[dict]:
    """The compared numbers beside their limits, in the limits' order."""
    return [{"name": k, "value": float(numbers[k]), "limit": float(v)}
            for k, v in limits.items()]


class Clock:
    """The window: starts now; `over()` once `seconds` have passed."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t0 = time.perf_counter()

    def over(self) -> bool:
        return time.perf_counter() - self.t0 >= self.seconds

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def release(device):
    import gc  # noqa: PLC0415

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
