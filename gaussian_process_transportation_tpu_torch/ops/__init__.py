from .linalg import (
    add_diagonal,
    cholesky_with_jitter,
    cho_solve_lower,
    tri_solve_lower,
    log_det_from_chol,
)

# The blocked Cholesky on the panel kernels: the large-N path.
from .blocked_chol import (
    BlockedCholesky,
    blocked_cholesky,
    cholesky_panels,
    factor_panel,
    gram_cholesky_solve,
    rbf_gram_panels,
    stationary_from_sqdist,
    stationary_gram_panels,
)

# The closed-form LML and its hyperparameter gradient in panel form.
from .blocked_lml import (
    blocked_lml_value_and_grad,
    kinv_panels,
    make_blocked_lml,
    stationary_dk_dd2,
    tri_inverse_panels,
)

# The mixed-precision variants in plain PyTorch (no route of condition()).
from .mixed_linalg import (
    blocked_cholesky as blocked_cholesky_mixed,
    ir_solve,
    pcg_solve,
    gram_chol_solve_mixed,
)

__all__ = [
    "add_diagonal",
    "cholesky_with_jitter",
    "cho_solve_lower",
    "tri_solve_lower",
    "log_det_from_chol",
    "BlockedCholesky",
    "blocked_cholesky",
    "cholesky_panels",
    "factor_panel",
    "gram_cholesky_solve",
    "rbf_gram_panels",
    "stationary_from_sqdist",
    "stationary_gram_panels",
    "blocked_lml_value_and_grad",
    "kinv_panels",
    "make_blocked_lml",
    "stationary_dk_dd2",
    "tri_inverse_panels",
    "blocked_cholesky_mixed",
    "ir_solve",
    "pcg_solve",
    "gram_chol_solve_mixed",
]
