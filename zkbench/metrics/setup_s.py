"""Process start to the window's start: imports, kernel load or build,
instance, witness pool, keygen, warm-up proves."""


def read(rec):
    return rec.get("setup_s")
