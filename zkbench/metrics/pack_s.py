"""The program's set-up packing on the host: its spans
`zk.flat.from_arrays` and every `zk.flat.pack_witness` that ended before
the first prove began, summed."""

from zkbench import program_spans


def read(rec):
    return program_spans.before_first_prove_s(
        ("zk.flat.from_arrays", "zk.flat.pack_witness"))
