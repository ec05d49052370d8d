"""The witness reduction's least time (`zkbench.costs_reduction` over
the card's measured rate, `zkbench.peak`) over the device time of its
NTT kernel launches (`k_ntt_pass`, the union of their intervals) in the
profiled proves, as a share; None where the record has no complete
profile, no rate or no circuit shape to count."""

from zkbench import costs_reduction


def read(rec):
    tr = rec.get("trace")
    peak = rec.get("peak_limb_products_per_s")
    shape = rec.get("reduction_shape")
    if not tr or not tr.get("reduction_device_s") or not peak or not shape:
        return None
    least = costs_reduction.least_seconds(shape, peak)
    return 100.0 * least / (tr["reduction_device_s"] / tr["proves"])
