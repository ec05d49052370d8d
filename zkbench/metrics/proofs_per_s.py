"""Proofs completed in the window over the window's seconds (the window
runs from its start to the end of its last prove)."""


def read(rec):
    if not rec.get("latencies_s") or rec["window_s"] <= 0:
        return None
    return len(rec["latencies_s"]) / rec["window_s"]
