"""The 95th percentile (ms) of the solve requests' latency, from the
moment the prefetcher pulls a request from the harness's source to the
moment its merged poses are on the host, over the requests finished in
the window's untraced part.  The cells run above capacity (the next
request is always due), so the queue sets this tail: a per-layer reading
of the streaming runtime, not an end-to-end metric."""

import numpy as np


def read(run):
    lat = run.facts.get("latency_ms")
    if not lat:
        return None
    return float(np.percentile(lat, 95, method="linear"))
