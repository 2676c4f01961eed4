"""Host milliseconds a call in the program's span
``exact_gp.lbfgs.update`` (the value and gradient, the keep test, the
histories; the first evaluation too), summed over the fit's iterations,
over the window's calls."""
from port_bench import program_spans

program_spans.start()


def read(t):
    return program_spans.ms_per_call(t, "exact_gp.lbfgs.update", host=True)
