"""Share (%) of the profiled stretch in which no kernel, copy or fill ran."""
from port_bench.readings import idle_share


def read(t):
    return idle_share(t)
