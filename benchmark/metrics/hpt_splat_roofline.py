"""Least time ÷ device time of `splat_bvh_kernel` over the traced
stretch of the path-traced hybrid frames, in percent: every wave's splat
segment launches it once. Device time from the profiler's trace; least
time from the work the reference counts for the same frames, all
segments (`rt_roofline.py`, the loop's `least_seconds`)."""

KERNEL = "splat_bvh_kernel"


def read(run):
    if run.profile is None:
        return None
    t = run.profile.kernel_seconds(KERNEL)
    if t <= 0:
        return None
    return 100.0 * run.loop.least_seconds(run.profile.items) / t
