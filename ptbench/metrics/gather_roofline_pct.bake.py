"""gather_roofline_pct.bake: `readers.gather_roofline_pct` over the traced
bake steps."""

from ptbench import readers

read = readers.gather_roofline_pct("bake")
