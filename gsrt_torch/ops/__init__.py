"""Per-splat math, binning and the kernel wrappers of the port."""
