"""Mean prove time less the reduction and MSM spans: proof assembly on
the host and the glue around the two spans."""


def read(rec):
    sp = rec.get("spans") or {}
    if not sp.get("prove_s"):
        return None
    rest = [p - r - m for p, r, m in zip(sp["prove_s"], sp["reduction_s"],
                                         sp["msm_s"])]
    return 1e3 * sum(rest) / len(rest)
