"""Mean span of the witness reduction (run_witness_reduction, the card
synchronised at both ends) over the traced window's proves."""


def read(rec):
    spans = (rec.get("spans") or {}).get("reduction_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
