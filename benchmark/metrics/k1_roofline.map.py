"""K1's share of its roofline in the traced iterations: the bound of the work the reference counts over K1's profiler time."""

from benchmark import readers


def read(rec: dict):
    return readers.roofline(rec, "K1")
