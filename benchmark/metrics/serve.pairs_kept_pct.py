"""Σ ServingRenderer.stats' culled pair totals over the window's frames
÷ the same views' uncut totals (the benchmark's frozen rect-span count):
what the temporal cull keeps."""

from benchmark import counts


def read(run):
    kept = base = 0
    loop = run.loop
    totals = {}
    for i in run.completed:
        st = i.get("stats")
        if st is None or "pairs" not in st:
            continue
        v = i["view"]
        if id(v) not in totals:
            totals[id(v)] = counts.rect_pairs(loop.cloud, loop.cov, v)
        kept += st["pairs"]
        base += totals[id(v)]
    return 100.0 * kept / base if base else None
