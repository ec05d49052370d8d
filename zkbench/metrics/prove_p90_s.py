"""The 90th percentile of every latency of the window (host clock, from
handing over the witness to the proof points on the host), linear
between the two nearest ranks."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_s")
    return float(np.percentile(lat, 90)) if lat else None
