"""CUDA runtime kernel launches per profiled prove, glue included."""


def read(rec):
    tr = rec.get("trace")
    return tr["launches"] / tr["proves"] if tr and tr["proves"] else None
