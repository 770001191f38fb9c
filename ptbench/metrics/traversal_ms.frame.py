"""traversal_ms.frame: `readers.traversal_ms` over the traced frames."""

from ptbench import readers

read = readers.traversal_ms("frame")
