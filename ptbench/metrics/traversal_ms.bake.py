"""traversal_ms.bake: `readers.traversal_ms` over the traced bake steps."""

from ptbench import readers

read = readers.traversal_ms("bake")
