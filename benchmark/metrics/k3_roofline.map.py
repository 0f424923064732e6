"""K3's share of its byte bound in the traced iterations."""

from benchmark import readers


def read(rec: dict):
    return readers.roofline(rec, "K3")
