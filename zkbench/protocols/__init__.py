"""One module a protocol, found by the `protocol` key of a configuration:
each drives the program's entry points for a cell and judges the run
with its plain reference (`zkbench/reference/`)."""
