"""Share (%) of the Armijo search's lane-candidates evaluated before the
lane met the test (the one that met it included): the program's tallies
``exact_gp.lbfgs.useful_candidate_lanes`` over ``candidate_lanes``."""
from port_bench import program_spans

program_spans.start()


def read(t):
    return program_spans.share(t, "exact_gp.lbfgs.useful_candidate_lanes",
                               "exact_gp.lbfgs.candidate_lanes")
