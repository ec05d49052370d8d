"""Median over the run's proves of the program's span
`zk.prove.witness_to_device`: the witness's copy from pageable host
memory to the card, the host blocked on it."""

from zkbench import program_spans


def read(rec):
    return program_spans.median_ms("zk.prove.witness_to_device")
