"""Median over the run's proves of the program's spans
`zk.prove.msm_launch` (the G1 batch's and the G2 MSM's, summed): digit
preparation and the enqueue of every MSM launch, on the host."""

from zkbench import program_spans


def read(rec):
    return program_spans.median_ms("zk.prove.msm_launch")
