"""Faults planted under the timed path, for the tests that see ``correct``
come out false (``tests/test_port_bench_faults.py``) and for reading a
fault's numbers on the card (``calibrate.py``).  Each entry names the
faults it can have in its ``FAULTS``: a context manager factory
``fault(cell)`` that patches the program while it is open.

* ``apply_unchanged``: the step returns its state unchanged: the transport
  hands back the demo where it was (no γ, no Ψ);
* ``fit_unchanged``: the fit returns the start θ;
* ``half_batch(entry)``: half of the batch left out: the entry is handed
  the first half of the targets again in place of the second half;
* ``apply_altered``: an answer altered where it is produced: the first
  entry of every ``transport_apply`` result moved by 1% of its field's
  largest value.
"""
from __future__ import annotations

import contextlib

from . import program

APPLY = "transport.gpt.transport_apply"
FIT = "models.exact_gp.fit_ensemble_fused"


@contextlib.contextmanager
def patched(path: str, make):
    """The program's attribute ``path`` replaced by ``make(original)``."""
    name, _, attr = path.rpartition(".")
    module = program.module(name)
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


def apply_unchanged(cell):
    def make(apply):
        def identity(aff, gp, traj, delta, ori=None):
            out = apply(aff, gp, traj, delta, ori=ori)
            lead = out.traj.shape[:-2]
            return out._replace(traj=traj.expand(*lead, *traj.shape),
                                delta=delta.expand(*lead, *delta.shape))
        return identity
    return patched(APPLY, make)


def fit_unchanged(cell):
    def make(fit):
        def start_theta(kernel, Xe, Ye, *a, **kw):
            thetas, lml = fit(kernel, Xe, Ye, *a, **kw)
            return kernel.theta.to(thetas).expand_as(thetas).clone(), lml
        return start_theta
    return patched(FIT, make)


def half_batch(entry: str):
    def fault(cell):
        def make(call):
            def first_half(kernel, source, targets, *a, **kw):
                half = max(1, targets.shape[0] // 2)
                reps = -(-targets.shape[0] // half)
                seen = targets[:half].repeat(reps, 1, 1)[:targets.shape[0]]
                return call(kernel, source, seen, *a, **kw)
            return first_half
        return patched(entry, make)
    return fault


def apply_altered(cell):
    def make(apply):
        def moved(*a, **kw):
            out = apply(*a, **kw)
            traj = out.traj.clone()
            traj.view(-1)[0] += 0.01 * traj.abs().max()
            return out._replace(traj=traj)
        return moved
    return patched(APPLY, make)
