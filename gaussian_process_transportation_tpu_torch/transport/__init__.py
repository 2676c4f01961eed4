from .core import PolicyTransport
from .gpt import GaussianProcessTransportation

# The JAX package also exports the transports of its other delta maps
# (transport/variants.py): not ported yet (ROADMAP.md, queue 1).
__all__ = [
    "PolicyTransport",
    "GaussianProcessTransportation",
]
