"""Device ms a training iteration spends outside K1, K2 and K3 (preprocess, binning, rank table, SSIM algebra, Adam), from the trace."""

from benchmark import readers


def read(rec: dict):
    return readers.other_busy_ms(rec, "iterations")
