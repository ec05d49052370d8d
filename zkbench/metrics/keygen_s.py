"""keygen_device on the card, host clock, ended by a synchronise."""


def read(rec):
    return rec.get("keygen_s")
