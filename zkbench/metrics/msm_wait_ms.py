"""Median over the run's proves of the program's spans
`zk.prove.msm_wait` (both resolves, summed): the host blocked on the MSMs'
collision flags, that is on the card's work still queued."""

from zkbench import program_spans


def read(rec):
    return program_spans.median_ms("zk.prove.msm_wait")
