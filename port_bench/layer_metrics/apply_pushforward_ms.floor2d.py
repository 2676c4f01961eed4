"""Milliseconds a call in the program's span ``gpt.apply.pushforward``
(J_Φ, min|det J_Φ|, the velocity and its variance), by its CUDA events over
the window's calls."""
from port_bench import program_spans

program_spans.start()


def read(t):
    return program_spans.ms_per_call(t, "gpt.apply.pushforward")
