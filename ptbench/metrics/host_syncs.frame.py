"""host_syncs.frame: the host syncs torch reported under the program's
`frame` span, per frame of the program-traced step (`spans.syncs_per_step`;
ctx["program_spans"])."""

from ptbench import spans

read = spans.syncs_per_step("frame", "frame")
