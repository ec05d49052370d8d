"""The least time of a prove's MSMs (`zkbench.costs` limb products over
the card's measured rate, `zkbench.peak`) over the device time of the
MSMs (the union of the device intervals of every operation launched
between the first MSM launch and the last result read back, over the
profiled proves), as a share."""

from zkbench import costs


def read(rec):
    tr = rec.get("trace")
    peak = rec.get("peak_limb_products_per_s")
    if not tr or not tr.get("msm_device_s") or not peak \
            or not rec.get("msm_terms"):
        return None
    least = costs.msm_limb_products(rec["msm_terms"]) / peak
    return 100.0 * least / (tr["msm_device_s"] / tr["proves"])
