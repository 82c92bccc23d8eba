"""Port parity for the three kernels' plain versions (`aclswarm_torch.ops`)
against the reference's Pallas kernels run as the reference's own tests
run them on the CPU: `interpret=True`. The CUDA kernels themselves are
held against these plain versions on the card
(`tests/test_torch_kernels_cuda.py`, `chip_smoke.py`).

Tolerances: K1 atol 5e-5 in float32 (the reference's own kernel
tolerance, `tests/test_ops.py`; f32 transcendental noise), K2 and K3
bit-identical (argmax tie rules and an integer min)."""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from aclswarm_torch import ops
from aclswarm_torch.ops import _build
from aclswarm_tpu.assignment.sinkhorn import round_dominant as round_ref
from aclswarm_tpu.ops import round_dominant_pallas, sinkhorn_log_pallas
from aclswarm_tpu.ops.flood_pallas import SENTINEL, flood_merge_pallas

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers


@pytest.mark.parametrize("n", [5, 64, 130])
def test_sinkhorn_plain_matches_pallas(n):
    rng = np.random.default_rng(n)
    cost = rng.random((n, n)).astype(np.float32) * 3
    ref = np.asarray(sinkhorn_log_pallas(jnp.asarray(cost), n_iters=40,
                                         interpret=True))
    out = ops.sinkhorn_log_plain(torch.from_numpy(cost), n_iters=40)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=5e-5)


def test_sinkhorn_wrapper_on_cpu_is_plain():
    cost = torch.rand(9, 9, generator=torch.Generator().manual_seed(0))
    before = dict(ops.LAUNCHES)
    np.testing.assert_array_equal(ops.sinkhorn_log(cost, 0.05, 30).numpy(),
                                  ops.sinkhorn_log_plain(cost, 0.05, 30)
                                  .numpy())
    assert ops.LAUNCHES == before      # no kernel ran


@pytest.mark.parametrize("n", [5, 17, 64, 130])
def test_rounding_plain_matches_pallas(n):
    rng = np.random.default_rng(n)
    plan = rng.normal(size=(n, n)).astype(np.float32) * 3
    ref = np.asarray(round_dominant_pallas(jnp.asarray(plan),
                                           interpret=True))
    out, rounds = ops.round_dominant_plain(torch.from_numpy(plan))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert sorted(out.tolist()) == list(range(n))
    assert 1 <= int(rounds) <= n


def test_rounding_all_ties():
    """All-equal plan: first-hit argmax in rows and columns decides."""
    plan = np.zeros((8, 8), np.float32)
    ref = np.asarray(round_dominant_pallas(jnp.asarray(plan),
                                           interpret=True))
    out, rounds = ops.round_dominant(torch.from_numpy(plan))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert int(rounds) == 8            # one commit per round


def test_rounding_max_rounds_cap():
    plan = torch.zeros(6, 6)
    out, rounds = ops.round_dominant_plain(plan, max_rounds=2)
    assert int(rounds) == 2 and int((out >= 0).sum()) == 2


def _stale_rounds(plan, max_rounds=None):
    """Torch model of `csrc/rounding.cu`'s rounds: each line keeps its
    first-hit argmax (n when its live entries are all -inf) and round r > 1
    rescans only the live rows whose argmax column was struck and the live
    columns whose argmax row was committed in round r - 1. Returns
    (permutation, rounds, lines rescanned after round 1, lines a full
    rescan of every live line would have read)."""
    n = plan.shape[0]
    max_rounds = n if max_rounds is None else max_rounds
    idx = torch.arange(n)
    no = torch.tensor([False])

    def scan(lines, mask):
        v = torch.where(mask[None, :], -math.inf, lines)
        return torch.where(v.max(dim=1).values > -math.inf,
                           torch.argmax(v, dim=1), n)

    assigned = torch.zeros(n, dtype=torch.bool)
    struck = torch.zeros(n, dtype=torch.bool)
    rowarg, colarg = scan(plan, struck), scan(plan.T, assigned)
    out = torch.full((n,), -1, dtype=torch.int32)
    rounds = rescanned = full = 0
    while rounds < max_rounds and not bool(assigned.all()):
        if rounds:
            rs = ~assigned & torch.cat([struck, no])[rowarg]
            cs = ~struck & torch.cat([assigned, no])[colarg]
            rowarg[rs] = scan(plan[rs], struck)
            colarg[cs] = scan(plan.T[cs], assigned)
            rescanned += int(rs.sum() + cs.sum())
        full += 2 * int((~assigned).sum())
        ok = ~assigned & (torch.cat([colarg, torch.tensor([-1])])[rowarg]
                          == idx)
        out[ok] = rowarg[ok].to(torch.int32)
        assigned |= ok
        struck[rowarg[ok]] = True
        rounds += 1
    return out, rounds, rescanned, full


def _check_stale_model(plan, max_rounds=None, pallas=True):
    out, rounds, _, _ = _stale_rounds(torch.from_numpy(plan), max_rounds)
    ref = np.asarray(round_ref(jnp.asarray(plan), max_rounds))
    np.testing.assert_array_equal(out.numpy(), ref)
    if pallas:          # the Pallas kernel always runs up to n rounds
        np.testing.assert_array_equal(out.numpy(), np.asarray(
            round_dominant_pallas(jnp.asarray(plan), interpret=True)))
    plain, plain_rounds = ops.round_dominant_plain(torch.from_numpy(plan),
                                                   max_rounds)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    assert rounds == int(plain_rounds)
    return out, rounds


def _tie_plan(n, seed):
    """Small integers (many exact ties), signed zeros, -inf lines."""
    rng = np.random.default_rng(seed)
    plan = rng.integers(-2, 3, (n, n)).astype(np.float32)
    zero = plan == 0
    plan[zero & (rng.random((n, n)) < 0.5)] = -0.0
    if n > 3:
        plan[rng.integers(n)] = -np.inf            # a row with no finite entry
        plan[:, rng.integers(n)] = -np.inf         # and a column
        plan[rng.random((n, n)) < 0.1] = -np.inf
    return plan


@pytest.mark.parametrize("n", [1, 5, 17, 64, 130])
def test_stale_rescans_match_reference_normal(n):
    """The premise of K2's stale-only rescans, bit for bit: seeded normal
    plans against the reference's XLA and Pallas roundings."""
    plan = np.random.default_rng(n).normal(size=(n, n)).astype(np.float32)
    out, _ = _check_stale_model(plan * 3)
    assert sorted(out.tolist()) == list(range(n))


@pytest.mark.parametrize("n,seed", [(5, 0), (17, 1), (40, 2), (64, 3),
                                    (130, 4)])
def test_stale_rescans_match_reference_ties(n, seed):
    """Integer plans full of ties, with +0.0/-0.0 and -inf rows, columns
    and entries."""
    _check_stale_model(_tie_plan(n, seed))


@pytest.mark.parametrize("kind", ["zeros", "signed_zeros", "ones"])
def test_stale_rescans_all_ties(kind):
    """All ties: one commit per round, every live line stale every round."""
    n = 24
    plan = np.zeros((n, n), np.float32)
    if kind == "signed_zeros":
        plan[np.random.default_rng(0).random((n, n)) < 0.5] = -0.0
    elif kind == "ones":
        plan += 1.0
    out, rounds = _check_stale_model(plan)
    assert rounds == n


@pytest.mark.parametrize("max_rounds", [0, 1, 2, 3])
def test_stale_rescans_max_rounds(max_rounds):
    """A cut leaves the rows not yet committed at -1, as the reference."""
    plan = np.random.default_rng(7).normal(size=(64, 64)).astype(np.float32)
    out, rounds = _check_stale_model(plan, max_rounds, pallas=False)
    assert rounds == max_rounds
    tie = _tie_plan(40, 9)
    _check_stale_model(tie, max_rounds, pallas=False)


def test_stale_rescans_all_minus_inf():
    """No finite entry: nothing commits and the loop runs its n rounds."""
    plan = np.full((6, 6), -np.inf, np.float32)
    out, rounds = _check_stale_model(plan)
    assert rounds == 6 and (out == -1).all()


def test_stale_rescans_read_less_than_full_rounds():
    """The property K2 relies on: after round 1 the stale lines are fewer
    than a full rescan of every live line per round reads, and fewer than
    n lines per round."""
    n = 130
    plan = np.random.default_rng(n).normal(size=(n, n)).astype(np.float32)
    out, rounds, rescanned, full = _stale_rounds(torch.from_numpy(plan * 3))
    assert rounds > 2
    assert 2 * n + rescanned < n * rounds
    assert rescanned < full - 2 * n


@settings(max_examples=30, deadline=None)
@given(n=st.integers(1, 12), seed=st.integers(0, 2**31 - 1),
       levels=st.integers(1, 4))
def test_stale_rescans_hypothesis(n, seed, levels):
    """Small tie-heavy plans: few distinct values, signed zeros, -inf."""
    rng = np.random.default_rng(seed)
    values = np.array([-np.inf, -0.0, 0.0, 1.0, -1.0, 2.0], np.float32)
    plan = rng.choice(values[:levels + 2], size=(n, n))
    _check_stale_model(plan.astype(np.float32))


def _flood_case(n, w, seed):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**30, (n, w)).astype(np.int32)
    comm = rng.random((n, n)) < 0.3
    comm[0] = False                    # a receiver with no sender
    return packed, comm


@pytest.mark.parametrize("n,w", [(7, 7), (64, 64), (130, 130), (7, 3),
                                 (64, 32), (130, 65)])
def test_flood_plain_matches_pallas(n, w):
    packed, comm = _flood_case(n, w, n + w)
    ref = np.asarray(flood_merge_pallas(jnp.asarray(packed),
                                        jnp.asarray(comm), interpret=True))
    out = ops.flood_merge_plain(torch.from_numpy(packed),
                                torch.from_numpy(comm))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out[0] == SENTINEL).all()


@pytest.mark.parametrize("block", [1, 5, 16, 64])
def test_flood_blocked_plain_is_identical(block):
    packed, comm = _flood_case(40, 33, 3)
    p, c = torch.from_numpy(packed), torch.from_numpy(comm)
    np.testing.assert_array_equal(
        ops.flood_merge(p, c, block=block).numpy(),
        ops.flood_merge_plain(p, c).numpy())


def _masked_umin(packed, comm, form):
    """numpy model of `csrc/flood.cu`'s arithmetic: comm packed into one
    32-bit word per (receiver, 32-sender chunk) (bit l = sender 32k + l, as
    `__ballot_sync` packs it) and the word inverted; then, from SENTINEL,
    ``acc = umin(x, acc)`` per sender. ``form='add'`` is the kernel's
    masking (`__viaddmin_u32`), ``x = p + top`` with bit s moved to the top
    (0 for a sender, 2^31 otherwise); ``form='or'`` is ``x = p | nm`` with
    bit s broadcast to all 32 bits by an arithmetic shift (0 or
    0xffffffff), folded in sender pairs three-way as `__vimin3_u32` would."""
    n, w = packed.shape
    chunks = -(-n // 32)
    bits = np.zeros((n, chunks * 32), bool)
    bits[:, :n] = comm
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    words = (bits.reshape(n, chunks, 32) * weights).sum(-1, dtype=np.uint32)
    p = np.zeros((chunks * 32, w), np.uint32)   # senders past n: any value
    p[:n] = packed.astype(np.uint32)
    acc = np.full((n, w), SENTINEL, np.uint32)
    for k in range(chunks):
        nw = ~words[:, k]
        if form == "add":
            for s in range(32):
                top = (nw << np.uint32(31 - s)) & np.uint32(1 << 31)
                acc = np.minimum(p[32 * k + s][None, :] + top[:, None], acc)
            continue
        for s in range(0, 32, 2):
            x0, x1 = (p[32 * k + t][None, :]
                      | ((nw << np.uint32(31 - t)).view(np.int32) >> 31)
                      .view(np.uint32)[:, None] for t in (s, s + 1))
            acc = np.minimum(np.minimum(acc, x0), x1)
    return acc.view(np.int32)


@pytest.mark.parametrize("form", ["add", "or"])
@pytest.mark.parametrize("n,w", [(7, 7), (33, 5), (64, 37), (70, 64)])
def test_flood_masked_unsigned_min_identity(n, w, form):
    """The identity K3's bit-identity rests on: with every packed value in
    [0, 2^31 - 1], the masked unsigned min equals the masked signed min —
    a non-sender's masked value (p + 2^31, or 0xffffffff) never wins and a
    receiver with no sender keeps SENTINEL."""
    from aclswarm_tpu.sim.localization import AGE_CAP

    rng = np.random.default_rng(1000 + n + w)
    packed = rng.integers(0, SENTINEL, (n, w), endpoint=True)
    for value in (0, (AGE_CAP << 16) | 0xFFFF, SENTINEL):
        packed.flat[rng.choice(n * w, max(2, n * w // 20),
                               replace=False)] = value
    packed = packed.astype(np.int32)
    comm = rng.random((n, n)) < 0.4
    comm[0] = False                    # a receiver with no sender
    comm[1] = False
    comm[1, 2] = True                  # its one sender holds SENTINEL
    packed[2] = SENTINEL
    out = _masked_umin(packed, comm, form)
    plain = ops.flood_merge_plain(torch.from_numpy(packed),
                                  torch.from_numpy(comm)).numpy()
    ref = np.asarray(flood_merge_pallas(jnp.asarray(packed),
                                        jnp.asarray(comm), interpret=True))
    np.testing.assert_array_equal(out, plain)
    np.testing.assert_array_equal(out, ref)
    assert (out[:2] == SENTINEL).all()


def test_kernel_checks_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        _build.check(torch.zeros(3, 3), "x", torch.float32, (3, 3))


def test_sources_and_build_rule():
    """Every kernel has a source with the replaced TPU kernel named in its
    opening note, built for sm_90a with a plain C interface."""
    for name, tpu in (("sinkhorn", "sinkhorn_pallas.py:sinkhorn_log_pallas"),
                      ("rounding", "rounding_pallas.py:round_dominant_pallas"),
                      ("flood", "flood_pallas.py:flood_merge_pallas")):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert tpu in src.replace("\n// ", "")
        assert 'extern "C"' in src and "torch" not in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    # one library from all sources: each entry point and the error-string
    # helper is defined in exactly one of them
    texts = [p.read_text() for p in _build._sources()]
    for symbol in (*_build._ENTRY, "kernel_error_string"):
        assert sum(f" {symbol}(" in t for t in texts) == 1, symbol
    assert _build.lib_path().parent == _build.BUILD_DIR
