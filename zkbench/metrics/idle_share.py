"""1 - (union of the device's kernel and copy intervals) / wall time,
over whole profiled proves, as a share; none where no profile was
complete."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
