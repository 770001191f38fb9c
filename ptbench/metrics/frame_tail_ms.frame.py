"""frame_tail_ms.frame: frame_ms_p95's reading (the 95th percentile of the
window's frame times on the host clock, in ms) as a per-layer metric, for
the cells whose frame tail swings too widely from run to run to be held to
a bound end to end."""

from ptbench.metrics.frame_ms_p95 import read  # noqa: F401
