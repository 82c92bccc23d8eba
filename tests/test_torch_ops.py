"""Port parity for the three kernels' plain versions (`aclswarm_torch.ops`)
against the reference's Pallas kernels run as the reference's own tests
run them on the CPU: `interpret=True`. The CUDA kernels themselves are
held against these plain versions on the card
(`tests/test_torch_kernels_cuda.py`, `chip_smoke.py`).

Tolerances: K1 atol 5e-5 in float32 (the reference's own kernel
tolerance, `tests/test_ops.py`; f32 transcendental noise), K2 and K3
bit-identical (argmax tie rules and an integer min)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aclswarm_torch import ops
from aclswarm_torch.ops import _build
from aclswarm_tpu.ops import round_dominant_pallas, sinkhorn_log_pallas
from aclswarm_tpu.ops.flood_pallas import SENTINEL, flood_merge_pallas


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
