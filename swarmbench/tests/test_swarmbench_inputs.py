"""The frozen generator against the program's, and the kernels' counts
on small shapes."""
import numpy as np
import pytest

from swarmbench import roofline
from swarmbench.traffic import formgen


def test_frozen_generator_draws_the_programs_points():
    from aclswarm_torch.harness import formgen as progen

    seed = 2**31 + 11
    specs = progen.generate_specs(30, seed=seed, l=20.0, w=20.0, h=3.0,
                                  min_dist=2.5, k=2)
    rng = np.random.default_rng(seed)
    assert np.array_equal(formgen.random_adjmat(rng, 30), specs[0].adjmat)
    for spec in specs:
        mine = formgen.sample_cylinder_points(rng, 30, 20.0, 20.0, 3.0, 2.5)
        assert np.array_equal(mine, spec.points)
    rng_a, rng_b = (np.random.default_rng(seed) for _ in range(2))
    assert np.array_equal(
        formgen.sample_cylinder_points(rng_a, 30, 20.0, 20.0, 0.0, 2.0),
        progen.sample_cylinder_points(rng_b, 30, 20.0, 20.0, 0.0, 2.0))


def test_draw_trial_follows_the_wave_drivers_order():
    from aclswarm_torch.harness import formgen as progen

    cfg = {"n": 20, "sim_fc": False, "sim_l": 20.0, "sim_w": 20.0,
           "sim_h": 3.0, "sim_min_dist": 2.5, "init_area_w": 15.0,
           "init_area_h": 15.0, "init_radius": 1.0}
    t = formgen.draw_trial(cfg, 7)
    specs = progen.generate_specs(20, seed=7, l=20.0, w=20.0, h=3.0,
                                  min_dist=2.5, k=2)
    start = progen.sample_cylinder_points(np.random.default_rng(7), 20,
                                          15.0, 15.0, 0.0, 2.0)
    assert np.array_equal(t["adj"], specs[0].adjmat)
    assert np.array_equal(t["points"], specs[0].points)
    assert np.array_equal(t["start"], start)


def test_kernel_counts():
    assert roofline.k1_counts(4, 10) == (10 * 16 * 10 + 2 * 16, 8 * 16)
    assert roofline.k1_counts(4, 10, problems=3)[0] == 3 * (1600 + 32)
    assert roofline.k2_counts(5, problems=2) == (0.0, 2 * (100 + 20))
    ops, nb = roofline.k3_counts(6, 3, [10, 12])
    assert ops == 2 * 10 * 3 + 2 * 12 * 3
    assert nb == 2 * (4 * 6 * 3 + 36 + 4 * 6 * 3)
    t, by = roofline.bound_s(67e12, 1.0)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = roofline.bound_s(0.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)


def test_roofline_share_from_a_reading():
    class R:
        kernel_s = {"sinkhorn_persistent_kernel(float const*)": 2e-3,
                    "flood_merge_kernel(int const*)": 1e-4}
        kernel_calls = [("K1", {"shape": (2, 1000, 1000), "iters": 200}),
                        ("K3", {"shape": (2, 1000, 500),
                                "comm": (2, 1000, 1000)})]
        adjacency_nnz = [999000, 998000]

    need = roofline.bound_s(*roofline.k1_counts(1000, 200, 2))[0]
    assert roofline.share(R, "K1") == pytest.approx(100 * need / 2e-3)
    assert roofline.share(R, "K2") is None
    ops, nb = roofline.k3_counts(1000, 500, [999000, 998000])
    assert roofline.share(R, "K3") == pytest.approx(
        100 * roofline.bound_s(ops, nb)[0] / 1e-4)
