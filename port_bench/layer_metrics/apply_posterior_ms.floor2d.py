"""Milliseconds a call in the program's span ``gpt.apply.posterior`` (the
affine map of the demo, the cross-Gram, the mean, the variance, the std),
by its CUDA events over the window's calls."""
from port_bench import program_spans

program_spans.start()


def read(t):
    return program_spans.ms_per_call(t, "gpt.apply.posterior")
