"""All pixels of all frames completed in the window ÷ the window's
seconds (W·H·spp over time, the reference's own unit), in millions."""


def read(run):
    px = sum(i["pixels"] for i in run.completed)
    return px / run.window_s / 1e6 if px else None
