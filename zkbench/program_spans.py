"""The program's own spans, read in the run's process after the window.

`zukelang_tpu_torch.util.spans()` is the program's ring of finished
spans (name, start_ns, end_ns, id, parent, request, attrs; host clock in
ns).  A prove runs under a span `zk.prove` whose request is its proof id,
and every span inside it carries that id.  The readers here return None
where the ring holds nothing to read: a program that records no spans,
or a run without such a span.

The ring keeps the newest spans.  Where it is full, older ones may have
gone: the readers then take only the proves that began after the oldest
kept span ended (their spans are all there), and set-up spans that are
gone are reported on standard error, not summed in part.
"""

from __future__ import annotations

import statistics
import sys
from typing import Iterable, List, Optional

PROVE = "zk.prove"


def ring() -> list:
    """The program's spans, oldest first; [] where it records none."""
    from zukelang_tpu_torch import util
    spans = getattr(util, "spans", None)
    return list(spans()) if spans is not None else []


def _full(spans: list) -> bool:
    from zukelang_tpu_torch import util
    return len(spans) >= util.RING_SIZE


def per_prove_s(name: str) -> Optional[List[float]]:
    """Seconds of the spans `name` summed by proof id, one entry a prove
    that has them, in proof-id order; None where there are none."""
    spans = ring()
    oldest = spans[0].end_ns if spans and _full(spans) else None
    proofs = {s.request for s in spans if s.name == PROVE
              and (oldest is None or s.start_ns > oldest)}
    sums = {}
    for s in spans:
        if s.name == name and s.request in proofs:
            sums[s.request] = sums.get(s.request, 0) + s.end_ns - s.start_ns
    return [sums[k] / 1e9 for k in sorted(sums)] or None


def median_ms(name: str) -> Optional[float]:
    """The median over the run's proves of `per_prove_s(name)`, in ms."""
    vals = per_prove_s(name)
    return 1e3 * statistics.median(vals) if vals else None


def before_first_prove_s(names: Iterable[str]) -> Optional[float]:
    """Seconds of every span named in `names` that ended before the first
    prove began; None where there is none, or where the ring is full and
    its oldest span ended after the first prove began (set-up spans may
    have gone: said on standard error)."""
    spans, names = ring(), set(names)
    first = min((s.start_ns for s in spans if s.name == PROVE),
                default=None)
    if spans and _full(spans) and (first is None
                                   or spans[0].end_ns > first):
        print(f"program_spans: the ring of {len(spans)} spans no longer "
              f"holds set-up; {sorted(names)} not read", file=sys.stderr)
        return None
    picked = [s.end_ns - s.start_ns for s in spans if s.name in names
              and (first is None or s.end_ns <= first)]
    return sum(picked) / 1e9 if picked else None
