"""Faults planted in the timed path, for the tests and for the readings
that a cell's limits are held against: each replaces one function of the
program through `patch(owner, name, value)` (pytest's
monkeypatch.setattr, or setattr for a whole process)."""

from __future__ import annotations

import torch


def unchanged_state(patch):
    """A train step that returns the map as it found it."""
    from gslivm_tpu_torch.models import training  # noqa: PLC0415

    step = training.train_step

    def frozen(params, optimizer, *a, **kw):
        keep = [p.detach().clone() for p in params.parameters()]
        out = step(params, optimizer, *a, **kw)
        with torch.no_grad():
            for p, k in zip(params.parameters(), keep):
                p.copy_(k)
        return out

    patch(training, "train_step", frozen)


def half_batch(patch):
    """A train step that leaves out half of its cameras (the history pair)
    and takes the mean over the rest."""
    from gslivm_tpu_torch.models import training  # noqa: PLC0415

    step = training.train_step

    def half(params, optimizer, cameras, gt_images, simi, *a, n_history_pairs=0, **kw):
        k = max(1, len(cameras) // 2)
        return step(params, optimizer, cameras[:k], gt_images[:k], simi, *a,
                    n_history_pairs=0, **kw)

    patch(training, "train_step", half)


def moved_centres(patch):
    """An append that writes each new gaussian's centre 1 mm off along x
    (its colour still taken at the GP's centre)."""
    from gslivm_tpu_torch.models import gaussian_model as gm  # noqa: PLC0415

    append = gm.append_points

    def moved(params, batch, *a, **kw):
        shift = torch.tensor([1e-3, 0.0, 0.0], device=batch.xyz.device)
        return append(params, batch._replace(xyz=batch.xyz + shift), *a, **kw)

    patch(gm, "append_points", moved)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "moved_centres": moved_centres}
