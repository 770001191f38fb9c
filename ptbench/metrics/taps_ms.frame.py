"""taps_ms.frame: device ms per frame of the kernels launched inside the
program's `shade.taps` spans (the material map taps, `_sample_packed`) in
the program-traced step (`spans.device_ms_per_step`;
ctx["program_spans"])."""

from ptbench import spans

read = spans.device_ms_per_step("frame", "frame", "shade.taps")
