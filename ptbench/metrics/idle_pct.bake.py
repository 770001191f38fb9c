"""idle_pct.bake: `readers.idle_pct` over the traced bake steps."""

from ptbench import readers

read = readers.idle_pct("bake")
