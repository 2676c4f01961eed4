"""Share (%) of the members that ``transport_apply`` moved through the fused
kernel: the program's tallies ``gpt.apply.fused_members`` over
``gpt.apply.members``, kept while the program's spans are on.  A program
without them reads nothing."""
from port_bench import program_spans

program_spans.start()


def read(t):
    return program_spans.share(t, "gpt.apply.fused_members", "gpt.apply.members")
