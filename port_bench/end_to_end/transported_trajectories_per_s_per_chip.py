"""Members transported by the calls completed in the window, over the
window's seconds."""
from port_bench.readings import members_per_s


def read(w):
    return members_per_s(w)
