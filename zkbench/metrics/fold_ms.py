"""Median over the run's proves of the program's span `zk.prove.fold`:
Pinocchio's ZK fold on the host (the tails and the randomisation by dv,
dw, dy of the eight proof points, in the program's host library), the card
idle."""

from zkbench import program_spans


def read(rec):
    return program_spans.median_ms("zk.prove.fold")
