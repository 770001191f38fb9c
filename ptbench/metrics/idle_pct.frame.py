"""idle_pct.frame: `readers.idle_pct` over the traced frames."""

from ptbench import readers

read = readers.idle_pct("frame")
