"""gather_roofline_pct.frame: `readers.gather_roofline_pct` over the traced
frames."""

from ptbench import readers

read = readers.gather_roofline_pct("frame")
