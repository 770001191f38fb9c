"""shading_ms.bake: `readers.shading_ms` over the traced bake steps."""

from ptbench import readers

read = readers.shading_ms("bake")
