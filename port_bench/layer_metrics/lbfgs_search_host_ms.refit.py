"""Host milliseconds a call in the program's span
``exact_gp.lbfgs.search`` (the Armijo search's value-only candidates),
summed over the fit's iterations, over the window's calls."""
from port_bench import program_spans

program_spans.start()


def read(t):
    return program_spans.ms_per_call(t, "exact_gp.lbfgs.search", host=True)
