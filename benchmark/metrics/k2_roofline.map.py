"""K2's share of its roofline in the traced iterations."""

from benchmark import readers


def read(rec: dict):
    return readers.roofline(rec, "K2")
