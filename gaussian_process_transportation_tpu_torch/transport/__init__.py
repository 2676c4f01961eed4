from .core import PolicyTransport
from .gpt import GaussianProcessTransportation
from .variants import (
    AffineTransportation,
    KMPTransport,
    LaplacianEditingTransport,
    MLPTransport,
    RandomForestTransport,
    NeuralTransport,
    EnsembleNeuralTransport,
    BijectiveTransport,
    EnsembleBijectiveTransport,
    SVGPTransport,
    GMRTransport,
    finite_difference_jacobian,
)

__all__ = [
    "PolicyTransport",
    "GaussianProcessTransportation",
    "AffineTransportation",
    "KMPTransport",
    "LaplacianEditingTransport",
    "MLPTransport",
    "RandomForestTransport",
    "NeuralTransport",
    "EnsembleNeuralTransport",
    "BijectiveTransport",
    "EnsembleBijectiveTransport",
    "SVGPTransport",
    "GMRTransport",
    "finite_difference_jacobian",
]
