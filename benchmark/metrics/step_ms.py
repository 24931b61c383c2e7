"""The window's seconds ÷ the training steps completed in it."""


def read(run):
    n = len(run.completed)
    return run.window_s / n * 1e3 if n else None
