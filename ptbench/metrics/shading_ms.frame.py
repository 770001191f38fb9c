"""shading_ms.frame: `readers.shading_ms` over the traced frames."""

from ptbench import readers

read = readers.shading_ms("frame")
