"""Mean span of a prove's MSMs, from the first MSM launch to the last
result read back (synchronised), over the traced window's proves."""


def read(rec):
    spans = (rec.get("spans") or {}).get("msm_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
