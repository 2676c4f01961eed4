"""Host milliseconds a call in the program's entry span
``gpt.transport_batched``: the host's time to launch the call's
work, over the window's calls."""
from port_bench import program_spans

program_spans.start()


def read(t):
    return program_spans.ms_per_call(t, "gpt.transport_batched", host=True)
