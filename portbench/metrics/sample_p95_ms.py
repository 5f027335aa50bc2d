"""sample_p95_ms: the 95th percentile, over all requests of the window, of
the time from a request's call into the sampler until its images are on the
device (host clock, after a device synchronize)."""

import statistics


def read(obs):
    lat = obs.get("latencies") if obs.get("kind") == "sample" else None
    if not lat or len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
