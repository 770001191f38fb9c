"""host_syncs.bake: the host syncs torch reported under the program's
`bake` span, per bake step of the program-traced step
(`spans.syncs_per_step`; ctx["program_spans"])."""

from ptbench import spans

read = spans.syncs_per_step("bake", "bake")
