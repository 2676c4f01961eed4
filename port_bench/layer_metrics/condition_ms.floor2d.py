"""Milliseconds a call in the program's span ``gpt.condition`` (the Grams,
the jitter, the permutes, the small Cholesky and inverse, α), by its CUDA
events over the window's calls."""
from port_bench import program_spans

program_spans.start()


def read(t):
    return program_spans.ms_per_call(t, "gpt.condition")
