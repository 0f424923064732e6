"""T1: what reading a tile's run from an unaligned offset costs the port's
K1 fetch (counterpart of tools/microbench_roll.py; kernel
`csrc/microbench_fetch.cu`).

Every tile sums the squares of its NCH chunks of 128 instance rows of the
row-major [L, 16] table, starting at row off[t] (2,040 tiles x 4 chunks,
the bench's supertile count):

  A  aligned offsets t * 512, K1's fetch (rows into one shared batch)
  B  sorted unaligned offsets, K1's fetch as it is
  C  sorted offsets, cp.async into two shared buffers (chunk i+1 copies
     while chunk i is summed: the TPU tool's two-slot DMA)
  D  sorted offsets, the TPU design's aligned two-chunk window, realigned
     by index in shared memory

B, C and D give the same sums. Inputs are drawn from default_rng(0) as the
JAX tool draws them. Run on the card:

    python -m gslivm_tpu_torch.tools.microbench_roll
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert, kernels
from ..ops.binning import CHUNK
from ..ops.rasterize_tiles import FEAT, _check_inst, _check_int_rows
from .timing import PEAK_BYTES, device_busy_ms, graph_time_ms

T = 2040
NCH = 4  # chunks per tile
VARIANTS = ("A", "B", "C", "D")
_FETCH = {"A": 0, "B": 0, "C": 1, "D": 2}  # the kernel's fetch of each variant


def make_inputs(variant: str, tiles: int = T, nch: int = NCH):
    """numpy (inst [16, L] feature-major, off [tiles], nch [tiles]), drawn as
    tools/microbench_roll.py:run draws them (L = tiles * nch * 128 + 256)."""
    rng = np.random.default_rng(0)
    inst = rng.standard_normal((FEAT, tiles * nch * CHUNK + 2 * CHUNK)).astype(np.float32)
    if variant == "A":
        off = np.arange(tiles, dtype=np.int32) * nch * CHUNK
    else:
        starts = np.cumsum(rng.integers(nch * CHUNK - 90, nch * CHUNK, tiles)).astype(np.int32)
        off = np.concatenate([[0], starts[:-1]]).astype(np.int32)
    return inst, off, np.full((tiles,), nch, np.int32)


def fetch_sum_plain(inst, off, nch):
    """The plain version: out[t] = sum of inst[off[t] + j, f]^2 over the
    run's rows j < 128 nch[t] that lie inside the table [0, L) and all 16
    f."""
    n = int(nch.max()) * CHUNK if nch.numel() else 0
    j = torch.arange(n, device=inst.device)
    rows = off.long()[:, None] + j
    live = (j[None, :] < nch.long()[:, None] * CHUNK) & (rows >= 0) & (rows < inst.shape[0])
    x = inst[torch.where(live, rows, 0)]
    return torch.where(live[..., None], x * x, 0.0).sum(dim=(1, 2))


def fetch_sum(inst, off, nch, variant: str = "B"):
    """T1 wrapper: [T] float32 sums (see fetch_sum_plain) through the
    variant's fetch. inst: [L, 16] float32; off, nch: [T] int32.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, or raise."""
    if variant not in _FETCH:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if not inst.is_cuda:
        return fetch_sum_plain(inst, off, nch)
    nt = off.shape[0]
    _check_inst(inst)
    _check_int_rows(nt, inst.device, off=off, nch=nch)
    out = torch.empty((nt,), dtype=torch.float32, device=inst.device)
    fn = kernels.library("microbench_fetch")
    with torch.cuda.device(inst.device):
        err = fn(inst.data_ptr(), off.data_ptr(), nch.data_ptr(), out.data_ptr(), nt,
                 inst.shape[0], _FETCH[variant], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"microbench_fetch kernel launch failed: CUDA error {err}")
    fetch_sum.launches += 1
    return out


fetch_sum.launches = 0  # T1 launches since the last reset


def bytes_moved(off, nch) -> int:
    """Bytes the function must move: each row of every run read once, the
    offsets and counts read, one float written per tile."""
    return int(nch.long().sum()) * CHUNK * FEAT * 4 + 3 * 4 * off.shape[0]


def run(variant: str, device="cuda", reps: int = 100) -> dict:
    """Time one variant on the card at the tool's size: `ms` by CUDA events
    around `reps` launches replayed from a CUDA graph (a launch from Python
    takes longer than the kernel), `kernel_ms` the kernel's own device time
    by torch.profiler."""
    inst_np, off_np, nch_np = make_inputs(variant)
    inst = convert.inst_from_numpy(inst_np, device=device)
    off = torch.from_numpy(off_np).to(inst.device)
    nch = torch.from_numpy(nch_np).to(inst.device)

    def call():
        return fetch_sum(inst, off, nch, variant)

    ms = graph_time_ms(call, reps=reps, device=device)
    kernel_ms = device_busy_ms(call, reps=20, device=device)["device_busy_ms"]
    moved = bytes_moved(off, nch)
    return {"variant": variant, "ms": ms, "kernel_ms": kernel_ms, "bytes": moved,
            "gb_per_s": moved / ms / 1e6, "bound_ms": moved / PEAK_BYTES * 1e3}


def main():
    rows = {v: run(v) for v in VARIANTS}
    for v, r in rows.items():
        print(f"variant {v}: {r['ms']:8.4f} ms (profiler {r['kernel_ms']:.4f} ms)  "
              f"{r['gb_per_s']:7.1f} GB/s  (bound {r['bound_ms']:.4f} ms)", flush=True)
    for v in ("B", "C", "D"):
        print(f"   {v} - A (unaligned cost): {rows[v]['ms'] - rows['A']['ms']:+.4f} ms", flush=True)


if __name__ == "__main__":
    main()
