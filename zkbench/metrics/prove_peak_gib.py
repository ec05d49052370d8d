"""The peak of `torch.cuda.max_memory_allocated` over the window's
proves, reset at the window's start; the resident CRS included."""


def read(rec):
    peak = rec.get("window_peak_bytes")
    return peak / 2 ** 30 if peak else None
