"""build_ms.frame: device ms per displayed frame of the kernels launched
inside the program's `turntable.build` spans (the W8 table's build on the
card, accel/device_build.py, with the gather of the triangles' vertices)
below its `turntable` span, in the program-traced step
(`spans.device_ms_per_step`; ctx["program_spans"])."""

from ptbench import spans

read = spans.device_ms_per_step("frame", "turntable", "turntable.build")
