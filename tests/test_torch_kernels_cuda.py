"""The CUDA kernels against their plain versions on the card, at the main
path's n=1000 shapes (`pytest -m cuda tests/test_torch_kernels_cuda.py`
on a machine with an H100 and nvcc; skipped elsewhere).

Tolerances as in `chip_smoke.py`: K1 atol 5e-5 and marginals 1e-4 (f32
reductions in another order); K2 and K3 bit-identical. The edge cases
cover ragged stripes and tiles (n=1001, n=64, w=37), K1 past its
shared-memory stripe limit (n=2500, the multi-launch design) and with
pinned/forbidden pairs, and K3's packed extremes (0, SENTINEL) with a
receiver that has no sender. K2 is held on all ties, n from 1 to 14,000,
+-0.0 ties and -inf lines, a pin/forbid plan and max_rounds cuts.

The auction LAP and CBAA are plain tensor code with polled device loops;
at n=257 the card must reproduce the CPU bit for bit from shared inputs
(one benefit matrix, one aligned formation), ties included. The ADMM gain
design is tensor code too: held against the CPU at n=64, with its kernel
basis computed on the host, and checked at n=1000 in float32. A short
`swarm4` trial flies through the trial driver on the card. A faulted fleet
shapes the kernels' inputs once more: a masked cost with half the fleet
dead and a lossy comm mask with the dead's rows empty."""
import math

import numpy as np
import pytest
import torch

from aclswarm_torch import gains, ops
from aclswarm_torch.assignment import auction, cbaa
from aclswarm_torch.core import geometry
from aclswarm_torch.faults import masking
from aclswarm_torch.gains import admm as gains_admm
from aclswarm_torch.harness import formgen
from aclswarm_torch.ops.flood import SENTINEL
from aclswarm_torch.sim.localization import AGE_CAP

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

pytestmark = pytest.mark.cuda
N = 1000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode; their "
                    "plain versions are held against the reference in "
                    "test_torch_ops.py)")
    return torch.device("cuda")


def _cost(card, seed=0, n=N):
    rng = np.random.default_rng(seed)
    q, p = rng.uniform(-65, 65, (n, 3)), rng.uniform(-65, 65, (n, 3))
    c = np.linalg.norm(q[:, None] - p[None], axis=-1)
    return torch.tensor(c / c.mean(), dtype=torch.float32, device=card)


def _masses(plan):
    return [torch.exp(torch.logsumexp(plan, dim=d)) for d in (0, 1)]


def test_sinkhorn_kernel(card):
    cost = _cost(card)
    before = ops.LAUNCHES["sinkhorn_log"]
    out = ops.sinkhorn_log(cost, 0.03, 200)
    assert ops.LAUNCHES["sinkhorn_log"] - before == 1     # one persistent solve
    ref = ops.sinkhorn_log_plain(cost, 0.03, 200)
    assert (out - ref).abs().max().item() <= 5e-5
    for mass in _masses(out):
        assert (mass - 1.0 / N).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n,launches", [(N + 1, 1), (64, 1), (1849, 1),
                                        (1900, 2 * 200 + 2),
                                        (2500, 2 * 200 + 2)])
def test_sinkhorn_kernel_sizes(card, n, launches):
    """Ragged stripes (n=1001; n=64 with fewer blocks than SMs) take the
    persistent design, up to its shared-memory stripe limit on an H100
    (n=1849); n=1900 and n=2500 are past it and take the multi-launch
    design."""
    cost = _cost(card, n, n)
    before = ops.LAUNCHES["sinkhorn_log"]
    out = ops.sinkhorn_log(cost, 0.03, 200)
    assert ops.LAUNCHES["sinkhorn_log"] - before == launches
    ref = ops.sinkhorn_log_plain(cost, 0.03, 200)
    assert (out - ref).abs().max().item() <= 5e-5
    for mass, mass_ref in zip(_masses(out), _masses(ref)):
        assert (mass - mass_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("iters", [0, 1, 2])
def test_sinkhorn_kernel_few_iterations(card, iters):
    """The persistent design's tags start at the caller's zeros (g = 0 for
    the first half-step, f = g = 0 when no iteration runs)."""
    cost = _cost(card, 4)
    out = ops.sinkhorn_log(cost, 0.03, iters)
    ref = ops.sinkhorn_log_plain(cost, 0.03, iters)
    assert (out - ref).abs().max().item() <= 5e-5


def test_sinkhorn_kernel_deterministic(card):
    """The persistent design reduces in a fixed order inside each block and
    waits on tagged entries, so repeated solves agree bit for bit."""
    cost = _cost(card, 5)
    first = ops.sinkhorn_log(cost, 0.03, 200)
    for _ in range(20):
        assert torch.equal(ops.sinkhorn_log(cost, 0.03, 200), first)


def test_sinkhorn_kernel_pin_forbid(card):
    """Pinned pairs cost 0, forbidden ones 4 (max + 1): forbidden entries
    of the plan reach |x| ~ 600, where one float32 step is 6.1e-5, so the
    bound is 5e-5 plus 2^-22 |plain| (the last bit of such an entry)."""
    cost = _cost(card, 2)
    idx = torch.arange(0, N, 50, device=card)
    pin = torch.zeros(N, N, dtype=torch.bool, device=card)
    pin[idx, (idx + 7) % N] = True
    g = torch.Generator(device=card).manual_seed(3)
    forbid = (torch.rand(N, N, generator=g, device=card) < 0.01) & ~pin
    cost = masking.apply_pin_forbid(cost, pin, forbid).contiguous()
    out = ops.sinkhorn_log(cost, 0.03, 200)
    ref = ops.sinkhorn_log_plain(cost, 0.03, 200)
    assert ((out - ref).abs() - 2.0**-22 * ref.abs()).max().item() <= 5e-5
    for mass, mass_ref in zip(_masses(out), _masses(ref)):
        assert (mass - mass_ref).abs().max().item() <= 1e-4


def _rounding_plan(card, kind):
    """The plans K2 is held on: a Sinkhorn plan of the main path's size;
    all ties (one commit per round, every live line stale each round);
    seeded normal plans at sizes around the grid (n=1, fewer lines than
    SMs, ragged stripes, past the single-block design's shared-memory
    limit of 13,673); small integers with +-0.0 ties and -inf rows,
    columns and entries; a pinned/forbidden Sinkhorn plan."""
    if kind == "plan":
        return ops.sinkhorn_log_plain(_cost(card, 1), 0.03, 200)
    if kind == "ties":
        return torch.zeros(N, N, device=card)
    g = torch.Generator(device=card).manual_seed(11)
    if kind.startswith("n="):
        n = int(kind[2:])
        return torch.randn(n, n, generator=g, device=card)
    if kind == "inf_zero":
        plan = torch.randint(-3, 4, (N, N), generator=g, device=card).float()
        neg0 = (plan == 0) & (torch.rand(N, N, generator=g, device=card) < .5)
        plan = torch.where(neg0, torch.full_like(plan, -0.0), plan)
        plan[[3, N // 2]] = -math.inf
        plan[:, [5, N - 1]] = -math.inf
        plan[torch.rand(N, N, generator=g, device=card) < 0.01] = -math.inf
        return plan.contiguous()
    assert kind == "pin_forbid"
    idx = torch.arange(0, N, 50, device=card)
    pin = torch.zeros(N, N, dtype=torch.bool, device=card)
    pin[idx, (idx + 7) % N] = True
    forbid = (torch.rand(N, N, generator=g, device=card) < 0.01) & ~pin
    cost = masking.apply_pin_forbid(_cost(card, 2), pin, forbid)
    return ops.sinkhorn_log_plain(cost.contiguous(), 0.03, 200)


@pytest.mark.parametrize("kind", ["plan", "ties", "n=1", "n=64", "n=1001",
                                  "n=4096", "n=14000", "inf_zero",
                                  "pin_forbid"])
def test_rounding_kernel(card, kind):
    """Bit-identical permutation and round count, one launch per call."""
    plan = _rounding_plan(card, kind)
    before = ops.LAUNCHES["round_dominant"]
    out, rounds = ops.round_dominant(plan)
    assert ops.LAUNCHES["round_dominant"] - before == 1
    ref, ref_rounds = ops.round_dominant_plain(plan)
    assert torch.equal(out, ref) and int(rounds) == int(ref_rounds)
    if kind != "inf_zero":          # -inf lines can leave rows unassigned
        n = plan.shape[0]
        assert torch.equal(torch.sort(out).values,
                           torch.arange(n, dtype=torch.int32, device=card))


@pytest.mark.parametrize("max_rounds", [0, 1, 3])
def test_rounding_kernel_max_rounds(card, max_rounds):
    """A cut leaves the rows not yet committed at -1."""
    plan = _rounding_plan(card, "plan")
    out, rounds = ops.round_dominant(plan, max_rounds)
    ref, ref_rounds = ops.round_dominant_plain(plan, max_rounds)
    assert torch.equal(out, ref) and int(rounds) == int(ref_rounds)
    assert int(rounds) == max_rounds and bool((out == -1).any())


def test_rounding_kernel_deterministic(card):
    """Round 1 combines column maxima with atomics that land in any order;
    the keys are order-free, so 20 calls agree bit for bit."""
    plan = _rounding_plan(card, "inf_zero")
    first, rounds = ops.round_dominant(plan)
    for _ in range(20):
        out, again = ops.round_dominant(plan)
        assert torch.equal(out, first) and int(again) == int(rounds)


def test_rounding_kernel_previous_design(card):
    """The single-block kernel, kept for timing, agrees too."""
    from aclswarm_torch.ops import _build

    plan = _rounding_plan(card, "plan")
    ref, ref_rounds = ops.round_dominant_plain(plan)
    out = torch.empty(N, dtype=torch.int32, device=card)
    rounds = torch.empty((), dtype=torch.int32, device=card)
    _build.launch("round_dominant_single_block_launch", card, plan.data_ptr(),
                  out.data_ptr(), rounds.data_ptr(), 1, N, N)
    assert torch.equal(out, ref) and int(rounds) == int(ref_rounds)


@pytest.mark.parametrize("w", [N, N // 2, 37])
def test_flood_kernel(card, w):
    g = torch.Generator(device=card).manual_seed(w)
    packed = torch.randint(0, 2**30, (N, w), generator=g, device=card,
                           dtype=torch.int32)
    comm = torch.rand(N, N, generator=g, device=card) < 0.3
    comm[0] = False
    assert torch.equal(ops.flood_merge(packed, comm),
                       ops.flood_merge_plain(packed, comm, block=100))


@pytest.mark.parametrize("n,w", [(N + 1, N + 1), (N + 1, 37), (N, N // 2),
                                 (64, 64)])
def test_flood_kernel_extremes(card, n, w):
    """Packed values over their whole range [0, SENTINEL] with 0, SENTINEL
    and the largest real value planted; an empty receiver row and a
    receiver whose one sender holds SENTINEL everywhere."""
    rng = np.random.default_rng(n + w)
    packed = rng.integers(0, SENTINEL, (n, w), endpoint=True)
    for value in (0, SENTINEL, (AGE_CAP << 16) | 0xFFFF):
        packed.flat[rng.choice(n * w, n, replace=False)] = value
    comm = rng.random((n, n)) < 0.3
    comm[0] = False
    comm[1] = False
    comm[1, 2] = True
    packed[2] = SENTINEL
    p = torch.tensor(packed.astype(np.int32), device=card)
    c = torch.tensor(comm, device=card)
    before = ops.LAUNCHES["flood_merge"]
    out = ops.flood_merge(p, c)
    assert ops.LAUNCHES["flood_merge"] - before == 1
    assert torch.equal(out, ops.flood_merge_plain(p, c, block=64))
    assert (out[:2] == SENTINEL).all()


@pytest.mark.parametrize("kind", ["distances", "ties"])
@pytest.mark.parametrize("max_rounds", [10000, 50])
def test_auction_card_equals_cpu(card, kind, max_rounds):
    """One benefit matrix, both devices: assignment, rounds, validity and
    prices equal, with the flag polled every 32 steps on the card and
    every step on the CPU. Integer benefits make every first-hit argmax
    decide."""
    n = 257
    if kind == "ties":
        g = torch.Generator().manual_seed(3)
        benefit = torch.randint(0, 4, (n, n), generator=g).float()
    else:
        benefit = -_cost(card, 7, n).cpu()
    cpu = auction.auction_lap(benefit, max_rounds=max_rounds)
    out = auction.auction_lap(benefit.to(card), max_rounds=max_rounds)
    assert torch.equal(out.row_to_col.cpu(), cpu.row_to_col)
    assert int(out.iters) == int(cpu.iters)
    assert bool(out.valid) == bool(cpu.valid)
    assert torch.equal(out.prices.cpu(), cpu.prices)


@pytest.mark.parametrize("task_block", [None, 64])
@pytest.mark.parametrize("warm", [False, True])
def test_cbaa_card_equals_cpu(card, task_block, warm):
    """One aligned formation (computed on the CPU), both devices: winner
    tables, assignment and round count equal, prices to the last bits (the
    card's norm sums its three squares in another order than the CPU's);
    then the alignment itself within 1e-3 m of the CPU's on a 60 m box
    (two SVD libraries and two float32 summation orders; an agent with
    two or three neighbors has an ill-conditioned fit)."""
    n = 257
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.uniform(-30, 30, (n, 3)), dtype=torch.float32)
    p = torch.tensor(rng.uniform(-30, 30, (n, 3)), dtype=torch.float32)
    adj = np.triu(rng.random((n, n)) < 0.05, 1)
    adj = torch.tensor((adj | adj.T), dtype=torch.float32)
    v2f = torch.tensor(rng.permutation(n), dtype=torch.int32)
    est = q[None] + torch.tensor(rng.normal(size=(n, n, 3)) * 0.05,
                                 dtype=torch.float32)
    pal = geometry.align_formation_local(q, p, adj, v2f, est=est)

    def run(dev, tables=None):
        if tables is not None:
            tables = cbaa.CbaaTables(*(t.to(dev) for t in tables))
        return cbaa.cbaa_assign(q.to(dev), pal.to(dev), adj.to(dev),
                                v2f.to(dev), task_block=task_block,
                                warm=tables)

    cpu, out = run("cpu"), run(card)
    if warm:
        carry = (cpu.price, cpu.who)
        cpu, out = run("cpu", carry), run(card, carry)
    for k in ("v2f", "f2v", "who"):
        assert torch.equal(getattr(out, k).cpu(), getattr(cpu, k)), k
    torch.testing.assert_close(out.price.cpu(), cpu.price, rtol=1e-6, atol=0)
    assert int(out.rounds) == int(cpu.rounds)
    assert bool(out.valid) == bool(cpu.valid)
    pal_card = geometry.align_formation_local(
        q.to(card), p.to(card), adj.to(card), v2f.to(card), est=est.to(card))
    assert (pal_card.cpu() - pal).abs().max().item() <= 1e-3


def _gain_case(n, seed, dtype="float32"):
    """A seeded non-planar formation and a `simform` graph (K_n minus up to
    n-4 edges)."""
    pts = (np.random.default_rng(seed).normal(size=(n, 3)) * 10).astype(dtype)
    return pts, formgen.random_adjmat(np.random.default_rng(seed), n)


@pytest.mark.parametrize("dtype, tol", [("float64", 1e-10),
                                        ("float32", 1e-4)])
def test_gains_card_equals_cpu(card, dtype, tol):
    """The ADMM gain design (tensor code, no kernel) on the card against
    the CPU: gains within 1e-10 at float64 (eigh) and 1e-4 at float32
    (Newton; two float32 matmul orders, where float32 and float64 differ
    by ~2e-6 at n=200), ADMM iterations equal."""
    n = 64
    pts, adj = _gain_case(n, 1, dtype)
    a, st = gains.solve_gains(pts, adj, max_nonedges=n - 4, telemetry=True,
                              device=card)
    b, st_cpu = gains.solve_gains(pts, adj, max_nonedges=n - 4,
                                  telemetry=True, device="cpu")
    assert a.device.type == "cuda" and a.dtype == b.dtype
    assert (a.cpu() - b).abs().max().item() <= tol
    assert st.iters == st_cpu.iters


def test_gains_kernel_basis_is_the_hosts(card):
    """Q reaches the card as LAPACK's gesdd computed it on the host, bit
    for bit: cuSOLVER picks another basis of the degenerate space."""
    pts, adj = _gain_case(48, 2)
    prob = gains_admm.problem(pts[None], adj[None], False, None, card)
    assert torch.equal(prob.q2[0].cpu(),
                       torch.from_numpy(gains_admm._kernel_2d(pts[:, :2])))
    assert torch.equal(prob.q1[0].cpu(), torch.from_numpy(
        gains_admm._kernel_1d(pts[:, 2], False)))


def test_gains_poll_interval_gives_the_same_bits(card):
    pts, adj = _gain_case(64, 3)
    outs = [gains.solve_gains(pts, adj, poll_every=k, device=card)
            for k in (1, 4, 40)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_gains_batch_against_serial_on_card(card):
    """Three formations in one batch against their serial solves (float32,
    1e-5: a formation's products inside the batch may round otherwise)."""
    n = 48
    cases = [_gain_case(n, s) for s in (4, 5, 6)]
    pts = np.stack([c[0] for c in cases])
    adjs = np.stack([c[1] for c in cases])
    batched = gains.solve_gains_batch(pts, adjs, max_nonedges=n - 4,
                                      device=card)
    for b in range(3):
        serial = gains.solve_gains(pts[b], adjs[b], max_nonedges=n - 4,
                                   device=card)
        assert (batched[b] - serial).abs().max().item() <= 1e-5


def test_gains_n1000_float32_invariants(card):
    """The main path's size: zero blocks exact at the non-edges, the trace
    within 1e-4 relative, the eigenstructure at `validate_gains(tol=2e-4)`
    (`tests/test_f32.py`), a warm re-solve of the same formation in fewer
    iterations."""
    n = 1000
    pts, adj = _gain_case(n, 7)
    carry0 = gains.init_carry(n, gains.planar_of(pts), device=card)
    A, carry, st = gains.solve_gains(pts, adj, max_nonedges=n - 4,
                                     carry=carry0, telemetry=True,
                                     device=card)
    off = torch.as_tensor((adj == 0) & ~np.eye(n, dtype=bool), device=card)
    assert bool((A.reshape(n, 3, n, 3).permute(0, 2, 1, 3)[off] == 0).all())
    assert abs(torch.trace(A.double()).item() + 3 * (n - 2)) \
        <= 1e-4 * 3 * (n - 2)
    v = gains.validate_gains(A.double(), pts.astype(np.float64), tol=2e-4)
    assert v["no_positive"] and v["kernel_ok"] \
        and v["strictly_negative_rest"]
    _, _, st_warm = gains.solve_gains(pts, adj, max_nonedges=n - 4,
                                      carry=carry, telemetry=True,
                                      device=card)
    assert st_warm.iters < st.iters


def test_swarm4_trial_on_the_card(card):
    """`swarm4` (seed 3, library gains, the default auction, float32) flown
    through `run_trial` on the card completes both formations."""
    from aclswarm_torch.harness import trials

    fsm = trials.run_trial(trials.TrialConfig(
        formation="swarm4", seed=3, verbose=False, device="cuda"), 0)
    assert fsm.completed, trials.NAMES[fsm.state]
    assert len(fsm.times) == 2 and fsm.execution == {}


# ------------------------------------------------ batched launches (trials)

def _costs(card, B, n, seed=0):
    return torch.stack([_cost(card, seed + b, n) for b in range(B)])


@pytest.mark.parametrize("B,n,launches", [(5, N, 2), (1, N, 1),
                                          (3, N + 1, 1)])
def test_sinkhorn_batched_equals_single_launches(card, B, n, launches):
    """B solves of one call equal B single launches bit for bit, in one
    cooperative launch per residency wave (n = 1000 on 132 SMs: three
    solves a wave), and the plain version at atol 5e-5."""
    cost = _costs(card, B, n)
    single = torch.stack([ops.sinkhorn_log(c) for c in cost])
    before = ops.LAUNCHES["sinkhorn_log"]
    plan = ops.sinkhorn_log(cost)
    made = ops.LAUNCHES["sinkhorn_log"] - before
    assert torch.equal(plan, single)
    assert made == launches or torch.cuda.get_device_properties(
        card).multi_processor_count != 132
    assert made < B or B == 1
    ref = ops.sinkhorn_log_plain(cost)
    assert (plan - ref).abs().max().item() <= 5e-5


@pytest.mark.parametrize("B,n", [(5, N), (1, N), (3, N + 1)])
def test_rounding_batched_equals_single_launches(card, B, n):
    """One launch rounds B plans, split over the SMs: the permutations and
    the round counts of B single launches, and of the plain version."""
    plans = ops.sinkhorn_log(_costs(card, B, n, seed=10))
    single = [ops.round_dominant(p) for p in plans]
    before = ops.LAUNCHES["round_dominant"]
    perm, rounds = ops.round_dominant(plans)
    assert ops.LAUNCHES["round_dominant"] - before == 1
    assert torch.equal(perm, torch.stack([s[0] for s in single]))
    assert torch.equal(rounds, torch.stack([s[1] for s in single]))
    ref, ref_rounds = ops.round_dominant_plain(plans)
    assert torch.equal(perm, ref) and torch.equal(rounds, ref_rounds)


def test_rounding_batched_previous_design(card):
    """The single-block kernel with one block per plan agrees too."""
    from aclswarm_torch.ops import _build

    plans = ops.sinkhorn_log(_costs(card, 3, N, seed=20))
    ref, ref_rounds = ops.round_dominant_plain(plans)
    out = torch.empty((3, N), dtype=torch.int32, device=card)
    rounds = torch.empty(3, dtype=torch.int32, device=card)
    _build.launch("round_dominant_single_block_launch", card,
                  plans.data_ptr(), out.data_ptr(), rounds.data_ptr(), 3, N,
                  N)
    assert torch.equal(out, ref) and torch.equal(rounds, ref_rounds)


@pytest.mark.parametrize("B,n,w", [(5, N, N), (5, N, N // 2), (1, N, N // 2),
                                   (3, N + 1, 37)])
def test_flood_batched_equals_single_launches(card, B, n, w):
    """One launch merges B problems (grid z = B), bit-identical to B single
    launches and to the plain version."""
    g = torch.Generator(device=card).manual_seed(B * w)
    packed = torch.randint(0, 2**30, (B, n, w), generator=g, device=card,
                           dtype=torch.int32)
    comm = torch.rand(B, n, n, generator=g, device=card) < 0.3
    comm[0, 0] = False
    before = ops.LAUNCHES["flood_merge"]
    out = ops.flood_merge(packed, comm)
    assert ops.LAUNCHES["flood_merge"] - before == 1
    assert torch.equal(out, torch.stack([ops.flood_merge(p, c)
                                         for p, c in zip(packed, comm)]))
    assert torch.equal(out, ops.flood_merge_plain(packed, comm, block=100))


def test_batched_rollout_on_the_card_equals_serial_assignments(card):
    """A small flooded Sinkhorn wave on the card: the batched rollout's
    assignments and auction flags equal the serial rollouts', and K3 runs
    once per tick for the whole wave."""
    from aclswarm_torch import sim
    from aclswarm_torch.core import types

    rng = np.random.default_rng(3)
    n, B, T = 64, 3, 60
    forms, states = [], []
    for _ in range(B):
        pts = rng.uniform(-20, 20, (n, 3))
        forms.append(types.make_formation(
            pts, np.ones((n, n)) - np.eye(n), rng.normal(size=(n, n, 3, 3))
            * 0.001, device=card))
        q0 = rng.uniform(-20, 20, (n, 3))
        q0[:, 2] = 1.0
        states.append(sim.init_state(q0, localization=True, device=card))
    sp = types.SafetyParams(bounds_min=(-50.0, -50.0, 0.0),
                            bounds_max=(50.0, 50.0, 10.0))
    cfg = sim.SimConfig(assignment="sinkhorn", localization="flooded",
                        flood_phases=2, assign_every=30, assign_eps=0.01,
                        colavoid_neighbors=8, dynamics="doubleint")
    ops.reset_launches()
    bf, bm = sim.batched_rollout(sim.stack_states(states),
                                 types.stack(forms), types.ControlGains(),
                                 sp, cfg, T)
    assert ops.LAUNCHES == {"sinkhorn_log": 2, "round_dominant": 2,
                            "flood_merge": T}
    for b in range(B):
        _, sm = sim.rollout(states[b], forms[b], types.ControlGains(), sp,
                            cfg, T)
        assert torch.equal(sm.v2f, bm.v2f[:, b])
        assert torch.equal(sm.auctioned, bm.auctioned[:, b])


def test_kernels_on_a_faulted_fleet(card):
    """K1, K2 and K3 on the inputs a fault schedule shapes at n=1000: the
    masked cost of a fleet with half its vehicles dead (their pairs pinned
    to their points at cost 0, every other pair of theirs and every pair
    onto a dead-owned point forbidden at 4 (max c + 1)), and the comm mask
    of a lossy link draw with the dead's rows and columns empty. K1 at
    5e-5 plus 2^-22 |plain| (the forbidden entries' last bit) and
    marginals 1e-4; K2 and K3 bit-identical; the card's link draws equal
    the CPU's bit for bit."""
    from aclswarm_torch import faults
    from aclswarm_torch.core import perm as permutil

    sched = faults.sample_schedule(7, N, dropout_frac=0.5, drop_tick=10,
                                   link_loss=0.6, device=card)
    alive = faults.alive_at(sched, 20)
    assert int(alive.sum()) == N // 2
    v2f = torch.as_tensor(np.random.default_rng(4).permutation(N),
                          dtype=torch.int32, device=card)
    pin, forbid = masking.pin_forbid(alive, v2f)
    cost = masking.apply_pin_forbid(_cost(card, 6), pin, forbid).contiguous()
    out = ops.sinkhorn_log(cost, 0.03, 200)
    ref = ops.sinkhorn_log_plain(cost, 0.03, 200)
    assert ((out - ref).abs() - 2.0**-22 * ref.abs()).max().item() <= 5e-5
    for mass, mass_ref in zip(_masses(out), _masses(ref)):
        assert (mass - mass_ref).abs().max().item() <= 1e-4
    perm, rounds = ops.round_dominant(out)
    perm_ref, rounds_ref = ops.round_dominant_plain(out)
    assert torch.equal(perm, perm_ref) and int(rounds) == int(rounds_ref)
    assert bool(permutil.is_valid(perm))
    assert torch.equal(perm[~alive], v2f[~alive])      # the dead stay put
    up = faults.link_up_at(sched, 20)
    cpu = faults.FaultSchedule(**{k: v.cpu() for k, v in vars(sched).items()})
    assert torch.equal(up.cpu(), faults.link_up_at(cpu, 20))
    comm = (torch.rand(N, N, generator=torch.Generator(device=card)
                       .manual_seed(5), device=card) < 0.3) \
        & up & alive[:, None] & alive[None, :]
    g = torch.Generator(device=card).manual_seed(8)
    packed = torch.randint(0, 2**30, (N, N // 2), generator=g, device=card,
                           dtype=torch.int32)
    merged = ops.flood_merge(packed, comm.contiguous())
    assert torch.equal(merged, ops.flood_merge_plain(packed, comm, block=64))
    assert (merged[~alive] == SENTINEL).all()


def test_checked_slice_on_the_card(card):
    """The Sinkhorn + flooded slice at n=64 with ``check_mode`` and
    ``telemetry`` on, on the card: K1, K2 and K3 launch on the checked
    path, every code is 0, q and v2f equal the unchecked card run bit for
    bit, and the counters equal the CPU run's."""
    from aclswarm_torch import ops, sim
    from aclswarm_torch.core.types import (ControlGains, SafetyParams,
                                           make_formation)
    from aclswarm_torch.harness import formgen as fg

    n = 64
    group = fg.generate_group(n, seed=3, l=40.0, w=40.0, h=3.0,
                              min_dist=3.0, k=1)
    pts = np.asarray(group["formations"][0]["points"])
    adj = np.asarray(group["adjmat"], float)
    rng = np.random.default_rng(3)
    gains = rng.normal(size=(n, n, 3, 3)) * 0.01
    q0 = rng.uniform(-30, 30, (n, 3))
    q0[:, 2] = 2.0
    sp = SafetyParams(bounds_min=(-100, -100, 0), bounds_max=(100, 100, 20))
    runs = {}
    for dev, on in ((card, "off"), (card, "on"), ("cpu", "on")):
        cfg = sim.SimConfig(assignment="sinkhorn", localization="flooded",
                            flood_phases=2, assign_every=10, check_mode=on,
                            telemetry=on)
        st = sim.init_state(q0, localization=True, checks=on == "on",
                            telemetry=on == "on", device=dev)
        form = make_formation(pts, adj, gains, device=dev)
        ops.reset_launches()
        final, m = sim.rollout(st, form, ControlGains(), sp, cfg, 30)
        runs[(str(dev), on)] = (final, m, dict(ops.LAUNCHES))
    off_final, off_m, _ = runs[(str(card), "off")]
    on_final, on_m, launches = runs[(str(card), "on")]
    cpu_final, _, _ = runs[("cpu", "on")]
    assert launches == {"sinkhorn_log": 3, "round_dominant": 3,
                        "flood_merge": 30}
    assert not on_m.inv_code.any()
    assert torch.equal(on_m.q, off_m.q) and torch.equal(on_m.v2f, off_m.v2f)
    for f in ("auctions", "assign_rounds", "reassigns", "flood_stale_max"):
        assert int(getattr(on_final.tel, f)) \
            == int(getattr(cpu_final.tel, f)), f
