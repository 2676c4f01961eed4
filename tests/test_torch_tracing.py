"""The port's own spans and counters (``utils/logging_utils.py``): the span
tree that the two batched entries give, one call id an entry call; the
outputs bit for bit the same with spans on and off; nothing recorded and no
profiler range while they are off; ``_lbfgs_elast``'s tallies, kept only
while spans are on, and its useful-candidate tally against a plain
recount of the same run's Armijo tests.  CPU, tiny shapes."""
from collections import Counter

import pytest
import torch

from gaussian_process_transportation_tpu_torch import kernels as K
from gaussian_process_transportation_tpu_torch.models import exact_gp
from gaussian_process_transportation_tpu_torch.ops.batched_linalg import spd_inverse_elast_auto
from gaussian_process_transportation_tpu_torch.transport import gpt
from gaussian_process_transportation_tpu_torch.utils import logging_utils as lu

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them.
torch.set_num_threads(1)

E, N, Q, MAXITER = 4, 8, 16, 2
APPLY = [("gpt.apply", "root"), ("gpt.apply.posterior", "gpt.apply"),
         ("gpt.apply.jacobian", "gpt.apply"), ("gpt.apply.pushforward", "gpt.apply")]
LBFGS = ([("exact_gp.lbfgs.update", "exact_gp.fit_ensemble")] * (1 + MAXITER)
         + [("exact_gp.lbfgs.direction", "exact_gp.fit_ensemble"),
            ("exact_gp.lbfgs.search", "exact_gp.fit_ensemble")] * MAXITER)
TREES = {
    "batched": ("gpt.transport_batched",
                [("gpt.affine", "root"), ("gpt.condition", "root")] + APPLY),
    "batched_opt": ("gpt.transport_batched_opt",
                    [("gpt.affine", "root"), ("exact_gp.fit_ensemble", "root"),
                     ("gpt.condition", "root")] + APPLY + LBFGS),
}
NAMES = {name for root, tree in TREES.values() for name in [root] + [c for c, _ in tree]}


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off and nothing recorded."""
    lu.spans(False)
    lu.collect()
    yield
    lu.spans(False)
    lu.collect()


def _case(seed=0):
    g = torch.Generator().manual_seed(seed)
    S = torch.rand(N, 2, generator=g, dtype=torch.float64)
    targets = S + 0.1 * torch.randn(E, N, 2, generator=g, dtype=torch.float64)
    X = torch.rand(Q, 2, generator=g, dtype=torch.float64)
    dX = 0.01 * torch.randn(Q, 2, generator=g, dtype=torch.float64)
    kern = K.Constant(1.0) * K.RBF(torch.ones(2, dtype=torch.float64)) + K.White(0.01)
    return kern, S, targets, X, dX


def _call(entry, case):
    if entry == "batched":
        return gpt.fit_and_transport_batched(*case)
    return gpt.fit_and_transport_batched_opt(*case, maxiter=MAXITER,
                                             generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("entry", sorted(TREES))
def test_entries_give_the_span_tree_once_per_call(entry):
    root, tree = TREES[entry]
    case = _case()
    lu.spans(True)
    for _ in range(2):
        _call(entry, case)
    got = lu.collect()
    recs = got.records
    assert sorted({r.call for r in recs}) == [recs[0].call, recs[0].call + 1]
    for call in {r.call for r in recs}:
        mine = [i for i, r in enumerate(recs) if r.call == call]
        roots = [i for i in mine if recs[i].parent is None]
        assert [recs[i].name for i in roots] == [root]
        edges = Counter((recs[i].name, "root" if recs[i].parent == roots[0]
                         else recs[recs[i].parent].name) for i in mine if i != roots[0])
        assert edges == Counter(tree)
    for r, own in zip(recs, got.self_ms()):
        assert r.start_ns <= r.end_ns and own >= 0.0 and r.device_ms is None, r
    # apply's tallies: two calls of E members, none fused on the CPU
    assert got.tallies["gpt.apply.members"] == 2 * E
    assert got.tallies["gpt.apply.fused_members"] == 0
    if entry == "batched":
        assert set(got.tallies) == {"gpt.apply.members", "gpt.apply.fused_members"}
    else:  # two calls of E members × 7 starts, 6 candidates a step
        lanes = 2 * E * 7 * 6 * MAXITER
        assert got.tallies["exact_gp.lbfgs.candidate_lanes"] == lanes
        assert 0 < got.tallies["exact_gp.lbfgs.useful_candidate_lanes"] <= lanes


@pytest.mark.parametrize("entry", sorted(TREES))
def test_outputs_are_the_same_bits_with_spans_on_and_off(entry):
    case = _case(3)
    off = _call(entry, case)
    lu.spans(True)
    on = _call(entry, case)
    lu.spans(False)
    assert lu.collect().records
    for name, a, b in zip(off._fields, off, on):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name


def test_condition_step_is_the_inline_sequence():
    """The shared conditioning step runs the ops the two entries each ran
    inline: the Gram with the jitter, one inverse call on (n, n, E), α."""
    kern, S, targets, _, _ = _case(5)
    aff, src_al, delta_b = gpt._affine_batched(S, targets, False, True)
    gp = gpt._condition_batched(kern, src_al, delta_b, 1e-10)
    eff = exact_gp._eff_jitter(src_al.dtype, 1e-10)
    K_b = kern(src_al) + eff * torch.eye(N, dtype=src_al.dtype)
    L_e, Kinv_e = spd_inverse_elast_auto(K_b.permute(1, 2, 0).contiguous())
    Kinv_b = Kinv_e.permute(2, 0, 1)
    assert torch.equal(gp.K_inv, Kinv_b) and torch.equal(gp.L, L_e.permute(2, 0, 1))
    assert torch.equal(gp.alpha, Kinv_b @ delta_b) and gp.X is src_al and gp.Y is delta_b
    assert torch.equal(delta_b, targets - src_al)


def _profiled_names(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def test_spans_off_record_nothing_and_open_no_range():
    case = _case()
    names = _profiled_names(lambda: [_call(entry, case) for entry in TREES])
    assert not names & NAMES
    got = lu.collect()
    assert got.records == [] and got.tallies == {}
    lu.spans(True)
    names = _profiled_names(lambda: [_call(entry, case) for entry in TREES])
    assert NAMES <= names  # the same calls with spans on: every span is a range


def _objective(a, b):
    """Per-lane f(x) = Σ_t a x² + b x⁴ on (T, L), float64."""
    def vg(x):
        return (a * x**2 + b * x**4).sum(0), 2 * a * x + 4 * b * x**3
    return vg


def test_the_per_member_route_is_one_call_an_entry_call():
    """Above BATCHED_MAX_N each member is transported alone, its apply under
    the entry's root span: one call id an entry call all the same."""
    n = gpt.BATCHED_MAX_N + 1
    g = torch.Generator().manual_seed(2)
    S = torch.rand(n, 2, generator=g, dtype=torch.float64)
    targets = S + 0.1 * torch.randn(2, n, 2, generator=g, dtype=torch.float64)
    kern, _, _, X, dX = _case()
    lu.spans(True)
    for _ in range(2):
        gpt.fit_and_transport_batched(kern, S, targets, X, dX)
    recs = lu.collect().records
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == ["gpt.transport_batched"] * 2
    assert len({r.call for r in recs}) == 2
    for i in roots:
        applies = [r for r in recs if r.name == "gpt.apply" and r.call == recs[i].call]
        assert len(applies) == 2 and all(r.parent == i for r in applies)


def test_the_fit_tallies_only_while_spans_are_on():
    kern, S, targets, _, _ = _case()

    def fit():
        exact_gp.fit_ensemble_fused(kern, S.expand(E, N, 2), targets - S, n_restarts=1,
                                    maxiter=MAXITER)

    fit()
    assert lu.collect().tallies == {}
    lu.spans(True)
    fit()
    tallies = lu.collect().tallies
    lanes = E * 2 * 6 * MAXITER  # members × starts, 6 candidates a step
    assert tallies["exact_gp.lbfgs.candidate_lanes"] == lanes
    assert 0 < tallies["exact_gp.lbfgs.useful_candidate_lanes"] <= lanes


def test_useful_candidate_lanes_equal_a_recount_of_the_armijo_tests():
    T, L, iters, mb, c = 3, 16, 4, 6, 1e-4
    g = torch.Generator().manual_seed(11)
    a = 0.5 + 30 * torch.rand(T, L, generator=g, dtype=torch.float64)
    b = 0.2 * torch.rand(T, L, generator=g, dtype=torch.float64)
    x0 = torch.randn(T, L, generator=g, dtype=torch.float64)
    vg = _objective(a, b)
    evals, cands = [], []

    def value_and_grad(x):
        v, grad = vg(x)
        evals.append((x.tolist(), v.tolist(), grad.tolist()))
        return v, grad

    def value(x):
        v = vg(x)[0]
        cands.append((x.tolist(), v.tolist()))
        return v

    f = exact_gp._lbfgs_elast
    lu.spans(True)
    wide = torch.full((T, 1), 1e3, dtype=torch.float64)
    f(value_and_grad, x0, -wide, wide, iters, max_backtrack=mb, armijo_c=c, value_b=value)
    tallies = lu.collect().tallies

    # the recount, in Python floats, from the points and values the run asked for
    x, v, grad = evals[0]
    useful = halvings = 0
    for i in range(iters):
        group = cands[i * mb:(i + 1) * mb]
        for lane in range(L):
            d = [group[0][0][r][lane] - x[r][lane] for r in range(T)]
            dg = min(sum(d[r] * grad[r][lane] for r in range(T)), -1e-30)
            t = 1.0
            for k in range(mb):
                useful += 1
                if group[k][1][lane] <= v[lane] + c * t * dg:
                    # met: every later candidate of the step asks for the same point
                    assert all(group[j][0][r][lane] == group[k][0][r][lane]
                               for j in range(k, mb) for r in range(T))
                    break
                t *= 0.5
                halvings += 1
        x_new, v_new, g_new = evals[i + 1]
        keep = [v_new[lane] <= v[lane] for lane in range(L)]
        x = [[x_new[r][lane] if keep[lane] else x[r][lane] for lane in range(L)]
             for r in range(T)]
        grad = [[g_new[r][lane] if keep[lane] else grad[r][lane] for lane in range(L)]
                for r in range(T)]
        v = [v_new[lane] if keep[lane] else v[lane] for lane in range(L)]
    assert halvings > 0 and useful < L * mb * iters  # both branches taken
    assert tallies == {"exact_gp.lbfgs.useful_candidate_lanes": useful,
                       "exact_gp.lbfgs.candidate_lanes": L * mb * iters}
