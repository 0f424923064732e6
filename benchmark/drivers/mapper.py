"""Driver of the incremental mapper in a closed loop: each frame of a
closed dolly path goes through `IncrementalMapper.add_frame`, then
`iters_per_frame` `train_iteration`s, back to back in one thread, the
next frame when the last is mapped.

Set-up: generate one cycle of frames, map frames with their iterations
until the mapper holds `setup_keyframes` keyframes (the sliding window +
2, so that every step from the check on draws the steady three cameras:
one current and one history pair), snapshot the mapper, and run the
first `check_iters` iterations of the check through `train_iteration`.
Window: frames from where set-up stopped, cycle after cycle, for
`--seconds`. After it: the PSNR of the set-up's keyframes by the
benchmark's arithmetic, then the checks against the plain reference.

Record: metrics map_frames_per_s, map_psnr_db; with --trace 1 the
host spans of each frame's ingest and iterations (each synchronised at
its end), and a device trace of `trace_frames` frames, with the
reference's pair counts of the traced iterations' renders.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from .. import scene, trace
from ..reference import losses as ref_losses
from ..reference import raster, roofline
from ..reference import train as ref_train
from . import common


def build(ctx):
    """The mapper, the generated cycle and the program's frames."""

    cfg, tr, cam = ctx.config, ctx.traffic, common.image_camera(ctx.config)
    path = scene.Path.from_dict(tr["path"])
    n_cycle = int(round(path.period_s / scene.SWEEP_DT))
    gen_frames = scene.map_frames(path, n_cycle, cam["width"], cam["height"], cam["fx"],
                                  cam["fy"], cfg["lidar"], ctx.seed, ctx.device)
    frames = [common.frame(f, cam, ctx.device) for f in gen_frames]
    mapper = common.mapper(cfg, ctx.seed, ctx.device)
    return mapper, gen_frames, frames


def run(ctx) -> dict:
    tr, cam = ctx.traffic, common.image_camera(ctx.config)
    iters, k = int(tr["iters_per_frame"]), int(tr["check_iters"])
    t_setup = time.perf_counter()
    gplog = common.GpLog(int(tr["gp_logged_calls"]), int(tr["logged_frames"]))
    with gplog:
        mapper, gen_frames, frames = build(ctx)
        by_camera = {id(f.camera): g for f, g in zip(frames, gen_frames)}
        log = common.AppendLog(int(tr["logged_frames"]), gplog)

        def map_frame(j: int):
            i = j % len(frames)
            info = mapper.add_frame(frames[i])
            log.add(mapper, info, gen_frames[i].R_wc, gen_frames[i].center, gen_frames[i].image)
            for _ in range(iters):
                mapper.train_iteration()

        j, want = 0, int(tr["setup_keyframes"])
        while len(mapper.cameras) < want:
            if j >= 10 * want:
                raise RuntimeError(f"{j} frames made {len(mapper.cameras)} keyframes of {want}")
            map_frame(j)
            j += 1
        n_setup, staged = j, len(mapper.cameras)
        common.prune_clear(mapper, k)
        snap = common.snapshot(mapper, lambda c: (by_camera[id(c)].R_wc, by_camera[id(c)].center,
                                                  by_camera[id(c)].image))
        prog = common.program_iterations(mapper, k)
        common.sync(ctx.device)
        setup_s = time.perf_counter() - t_setup

        # the window
        spans = {"ingest": [], "train": []}
        traced: list = []
        done = 0
        clock = common.Clock(ctx.seconds)
        while True:
            if ctx.trace:
                timed_frame(ctx, mapper, frames[j % len(frames)], iters, spans)
            else:
                map_frame(j)
            j += 1
            done += 1
            if clock.over():
                break
        common.sync(ctx.device)
        window_s = clock.elapsed()
        peak = common.memory_peak(ctx.device)
        # the device trace: frames after the window, whose host spans the
        # profiler would slow
        if ctx.trace:
            bufs = state_buffers(mapper, iters * int(tr["trace_frames"]))
            with ctx.tracer.window():
                for f in range(int(tr["trace_frames"])):
                    traced += traced_frame(
                        ctx, mapper, frames[j % len(frames)], iters,
                        lambda c: (by_camera[id(c)].R_wc, by_camera[id(c)].center),
                        bufs[f * iters:(f + 1) * iters])
                    j += 1

        with torch.no_grad():
            scores = []
            for i in range(staged):
                out = mapper.render_keyframe(i)
                gt = torch.as_tensor(by_camera[id(mapper.cameras[i])].image).to(
                    out.color.device).permute(2, 0, 1).double() / 255.0
                scores.append(float(ref_losses.psnr(out.color.double(), gt)))
    rec = {"metrics": {"map_frames_per_s": done / window_s,
                       "map_psnr_db": float(np.mean(scores)),
                       "setup_s": setup_s},
           "attempted": done, "failed": 0, "memory_peak_bytes": peak,
           "window_s": window_s, "frames": done, "iters_per_frame": iters, "spans": spans}
    if ctx.trace:
        rec.update(traced_record(ctx, traced))
    rec["program"] = {"check_overflow": prog.overflow, "check_cameras": check_cameras(ctx, snap),
                      "setup_frames": n_setup,
                      "keyframes": staged, "budget_refits": mapper.budget_refits,
                      "overflow_escalations": mapper.overflow_escalations,
                      "gaussians": int(mapper.params.n_active)}
    ctx.log("program", rec["program"])
    del mapper, frames
    common.release(ctx.device)

    numbers = common.train_numbers(snap, prog, ctx.config, k, ctx.device, ctx.control)
    numbers.update(common.ingest_numbers(log, cam["fx"], cam["fy"], ctx.control))
    numbers.update(common.append_numbers(log, ctx.control))
    numbers.update(common.gp_numbers(gplog, ctx.config["program"]["gp"], ctx.control))
    ctx.log("check readings", {kk: numbers[kk] for kk in numbers
                               if kk not in ("losses", "ref_losses")},
            "losses", numbers["losses"], "reference", numbers["ref_losses"])
    rec["checks"] = common.checks(numbers, tr["limits"])
    return rec


def check_cameras(ctx, snap) -> int:
    """How many cameras the first checked iteration draws, by the
    reference's copy of the sampler."""
    gp = ctx.config["program"]["gp"]
    rng = np.random.default_rng()
    rng.bit_generator.state = copy.deepcopy(snap.rng_state)
    curr, pairs = ref_train.sample_cameras(
        rng, set(snap.used_curr), set(snap.used_hist), len(snap.keyframes),
        gp["image_sliding_window"], gp["curr_cam_per_iter"], gp["history_cam_per_iter"])
    return len(curr) + 2 * len(pairs)


def timed_frame(ctx, mapper, frame, iters: int, spans: dict):
    """A frame with its ingest and its iterations each synchronised and
    timed on the host clock, inside the benchmark's spans."""
    t0 = time.perf_counter()
    with ctx.tracer.span("ingest"):
        mapper.add_frame(frame)
        common.sync(ctx.device)
    t1 = time.perf_counter()
    with ctx.tracer.span("train"):
        for _ in range(iters):
            mapper.train_iteration()
        common.sync(ctx.device)
    spans["ingest"].append(t1 - t0)
    spans["train"].append((time.perf_counter() - t1) / iters)


def _leaves(p):
    return (p.xyz, p.scaling, p.rotation, p.opacity, p.features_dc[:, 0], p.n_active)


def state_buffers(mapper, iters: int) -> list:
    """Buffers, made before the trace, for each traced iteration's copy of
    the map (so that the copies allocate nothing inside it)."""
    return [[torch.empty_like(t) for t in _leaves(mapper.params)] for _ in range(iters)]


def traced_frame(ctx, mapper, frame, iters: int, pose_of, bufs) -> list:
    """A frame inside the device trace, in the spans of timed_frame, keeping
    before each iteration what the reference needs to count its renders'
    work: the live parameters (copied on the device into `bufs`, or anew
    where the map outgrew them), the sampler, the keyframes' poses (by
    pose_of, the benchmark's). Its host times are not kept: the profiler
    slows them."""
    with ctx.tracer.span("ingest"):
        mapper.add_frame(frame)
        common.sync(ctx.device)
    states = []
    with ctx.tracer.span("train"):
        for i in range(iters):
            # whole buffers: reading n_active would wait for the card
            leaves = [b.copy_(t.detach()) if b.shape == t.shape else t.detach().clone()
                      for b, t in zip(bufs[i], _leaves(mapper.params))]
            states.append((leaves[:5], leaves[5], copy.deepcopy(mapper.rng.bit_generator.state),
                           set(mapper._used_curr), set(mapper._used_hist),
                           [pose_of(c) for c in mapper.cameras]))
            mapper.train_iteration()
        common.sync(ctx.device)
    return states


def traced_record(ctx, states) -> dict:
    """The device trace's numbers and the reference's counts of the work of
    the traced iterations' kernels."""
    w = ctx.tracer.result
    gp, cam = ctx.config["program"]["gp"], common.image_camera(ctx.config)
    W, H, fx, fy = cam["width"], cam["height"], cam["fx"], cam["fy"]
    k1 = k2 = k3 = 0.0
    bg = torch.ones(3, dtype=torch.float64, device=ctx.device)
    renders = 0
    for bufs, n_active, rng_state, used_c, used_h, poses in states:
        n = int(n_active)
        g64 = raster.Gaussians(*(t[:n].double() for t in bufs))
        rng = np.random.default_rng()
        rng.bit_generator.state = rng_state
        curr, pairs = ref_train.sample_cameras(
            rng, used_c, used_h, len(poses), gp["image_sliding_window"],
            gp["curr_cam_per_iter"], gp["history_cam_per_iter"])
        for i in curr + [i for pr in pairs for i in pr]:
            v = raster.make_view(*poses[i], W, H, fx, fy, torch.float64, ctx.device)
            pairs_n, visible = raster.contributing_pairs(g64, v, bg)
            k1 += roofline.k1_bound_s(pairs_n, visible, W * H)
            k2 += roofline.k2_bound_s(pairs_n, visible, W * H)
            k3 += 2 * roofline.k3_bound_s(9, W * H)
            renders += 1
    in_train = trace.in_spans(w.device, w.spans, "train")
    secs = trace.seconds_by_kernel(in_train)
    # every render launches K1 and K2 once and K3 twice (the SSIM's blur
    # and its adjoint): fewer records than that, and some were lost
    counts = trace.count_by_kernel(in_train)
    whole = w.records_whole and counts == {"K1": renders, "K2": renders, "K3": 2 * renders}
    if not whole:
        ctx.log("trace records not whole: kernels in the train spans", counts,
                "for", renders, "renders")
    iters = len(states)
    return {"trace": {"window_s": w.window_s, "busy_s": w.busy_s,
                      "records_whole": whole, "kernel_counts": counts, "iterations": iters,
                      "renders": renders, "kernel_s": secs,
                      "bound_s": {"K1": k1, "K2": k2, "K3": k3},
                      "other_busy_s": sum(secs.values()) - secs["K1"] - secs["K2"] - secs["K3"]},
            "breakdown": trace.breakdown(w)}
