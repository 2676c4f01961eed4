from .core import PolicyTransport
from .gpt import GaussianProcessTransportation
from .variants import (
    AffineTransportation,
    KMPTransport,
    LaplacianEditingTransport,
    finite_difference_jacobian,
)

# The JAX package also exports the transports of its learned delta maps
# (the rest of transport/variants.py): not ported yet (ROADMAP.md, queue 1).
__all__ = [
    "PolicyTransport",
    "GaussianProcessTransportation",
    "AffineTransportation",
    "KMPTransport",
    "LaplacianEditingTransport",
    "finite_difference_jacobian",
]
