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
from . import smc

# The JAX package also exports its mesh, ensemble and sharded modules
# (make_mesh, ensemble_sharding, replicated, transport_ensemble,
# posterior_transport_ensemble, make_ensemble_train_step,
# ShardedBlockedCholesky, sharded_gram_cholesky_solve, fit_sharded,
# make_sharded_lml, sharded_lml_value_and_grad): the multi-device slice,
# not ported yet (ROADMAP.md, queue 1).
__all__ = [
    "hmc",
    "hmc_batched",
    "nuts",
    "nuts_batched",
    "run_hmc_checkpointed",
    "run_hmc_batched_checkpointed",
    "sample_gp_posterior",
    "split_rhat",
    "effective_sample_size",
    "smc",
]
