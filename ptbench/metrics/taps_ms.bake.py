"""taps_ms.bake: device ms per bake step of the kernels launched inside the
program's `shade.taps` spans in the program-traced step
(`spans.device_ms_per_step`; ctx["program_spans"])."""

from ptbench import spans

read = spans.device_ms_per_step("bake", "bake", "shade.taps")
