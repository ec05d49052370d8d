"""Median over the run's proves of the program's span
`zk.prove.assemble`: the proof assembled from host points in pure Python
(six scalar multiplications and the additions), the card idle."""

from zkbench import program_spans


def read(rec):
    return program_spans.median_ms("zk.prove.assemble")
