"""turntable_syncs.frame: the host syncs torch reported under the program's
`turntable` span (the turn's rotation, build, geometry switch, samples and
display), per displayed frame of the program-traced step
(`spans.syncs_per_step`; ctx["program_spans"])."""

from ptbench import spans

read = spans.syncs_per_step("frame", "turntable")
