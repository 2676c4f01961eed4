from .mesh import make_mesh, ensemble_sharding, replicated
from .ensemble import (
    transport_ensemble,
    posterior_transport_ensemble,
    make_ensemble_train_step,
)
from .samplers import (
    hmc,
    hmc_batched,
    nuts,
    nuts_batched,
    sample_gp_posterior,
    split_rhat,
    effective_sample_size,
)
from .checkpointed import run_hmc_checkpointed, run_hmc_batched_checkpointed
from .sharded_chol import ShardedBlockedCholesky, sharded_gram_cholesky_solve
from .sharded_lml import (
    fit_sharded,
    make_sharded_lml,
    sharded_lml_value_and_grad,
)
from . import smc

__all__ = [
    "make_mesh",
    "ensemble_sharding",
    "replicated",
    "transport_ensemble",
    "posterior_transport_ensemble",
    "make_ensemble_train_step",
    "hmc",
    "hmc_batched",
    "nuts",
    "nuts_batched",
    "run_hmc_checkpointed",
    "run_hmc_batched_checkpointed",
    "sample_gp_posterior",
    "split_rhat",
    "effective_sample_size",
    "ShardedBlockedCholesky",
    "sharded_gram_cholesky_solve",
    "fit_sharded",
    "make_sharded_lml",
    "sharded_lml_value_and_grad",
    "smc",
]
