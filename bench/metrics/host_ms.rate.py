"""host_ms.rate: host_ms.sat's reading in an open-loop cell, where it
moves the token-gap tail."""
from bench.harness import catalog


def read(ctx):
    return catalog.reader("host_ms.sat").read(ctx)
