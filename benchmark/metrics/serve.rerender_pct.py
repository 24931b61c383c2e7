"""Σ ServingRenderer.stats' full_renders ÷ frames: strict serving renders
a frame whose cull lost content again, without the cull."""


def read(run):
    st = [i["stats"] for i in run.completed if "stats" in i]
    return 100.0 * sum(s["full_renders"] for s in st) / len(st) if st \
        else None
