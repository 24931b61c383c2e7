"""95th percentile over every frame of the window of the host clock from
the entry call until the frame is synchronised on the card. A failed
frame counts as missing any limit: it takes the window's length."""

from benchmark.harness import percentile


def read(run):
    if not run.items:
        return None
    lat = [i["latency_s"] if i.get("latency_s") is not None
           else run.window_s for i in run.items]
    return percentile(lat, 95.0) * 1e3
