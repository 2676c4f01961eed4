from .stationary import (
    Kernel,
    RBF,
    Matern,
    White,
    Constant,
    Sum,
    Product,
)

__all__ = [
    "Kernel",
    "RBF",
    "Matern",
    "White",
    "Constant",
    "Sum",
    "Product",
]
