"""Host-side helpers of the port (counterpart of `gsrt.utils`): image I/O
with a PNG codec of its own, quality metrics, heatmaps, render statistics,
progressive accumulation, sanitizers, the program's tracer and
checkpoints.
`gsrt.utils.oracle` is a test aid of the JAX package and has no
counterpart here."""
