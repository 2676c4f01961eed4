from .stationary import (
    DEFAULT_BOUNDS,
    Kernel,
    RBF,
    Matern,
    White,
    Constant,
    Sum,
    Product,
)

__all__ = [
    "DEFAULT_BOUNDS",
    "Kernel",
    "RBF",
    "Matern",
    "White",
    "Constant",
    "Sum",
    "Product",
]
