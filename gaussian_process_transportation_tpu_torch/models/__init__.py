from .exact_gp import (
    ExactGP,
    condition,
    log_marginal_likelihood,
    fit,
    fit_jit,
    fit_blocked,
    condition_blocked,
    predict,
    predict_cov,
    sample_y,
    jacobian,
    variance_gradient,
    white_noise_level,
)
from .gp_regressor import GaussianProcess
from .affine import AffineTransform
from .kmp import KMP
from .laplacian_editing import LaplacianEditing
from .mlp import MLP, EnsembleMLP
from .flows import BijectiveNetwork, EnsembleBijectiveNetwork
from .random_forest import EnsembleRandomForest
from .svgp import StochasticVariationalGaussianProcess
from .gmr import GMR

__all__ = [
    "ExactGP",
    "condition",
    "log_marginal_likelihood",
    "fit",
    "fit_jit",
    "fit_blocked",
    "condition_blocked",
    "predict",
    "predict_cov",
    "sample_y",
    "jacobian",
    "variance_gradient",
    "white_noise_level",
    "GaussianProcess",
    "AffineTransform",
    "KMP",
    "LaplacianEditing",
    "MLP",
    "EnsembleMLP",
    "BijectiveNetwork",
    "EnsembleBijectiveNetwork",
    "EnsembleRandomForest",
    "StochasticVariationalGaussianProcess",
]
