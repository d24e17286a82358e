"""The benchmark's own work count: op counts pinned for final_scene's real
spheres and the Cornell box's rects, and equal to the program's."""

import pytest

from benchmark import roofline


def test_final_scene_ops_pinned():
    # 485 real spheres: 970 coefficient rows of 17 multiply-adds, + 2 FLOP a sphere
    assert roofline.coef_rows(485, 0) == 970
    assert roofline.march_flop(485, 0) == 2 * 17 * 970 + 2 * 485 == 33950


def test_cornell_rects_ops_pinned():
    # 6 walls and light + 2 boxes of 6 rects: 18 rects, 6 rows each
    assert roofline.coef_rows(0, 18) == 108
    assert roofline.march_flop(0, 18) == 3672


def test_equal_to_the_program_arithmetic():
    from rtweekend_tpu_torch.utils import roofline as prog

    for s, r in ((485, 0), (0, 18), (2, 1), (487, 0)):
        assert roofline.march_flop(s, r) == prog.march_flop(s, r)
        assert roofline.coef_rows(s, r) == prog.coef_rows(s, r)
    assert (roofline.NOISE_OPS, roofline.IMAGE_OPS, roofline.SKY_OPS) == (
        prog.NOISE_OPS, prog.IMAGE_OPS, prog.SKY_OPS)
    assert (roofline.FP32_FLOPS, roofline.HBM_BYTES_S) == (prog.FP32_FLOPS, prog.HBM_BYTES_S)


def test_least_time():
    # one final_scene 1-spp batch: 810,000 rays, 2.81 live ray-bounces a ray
    rays = 810_000
    got = roofline.least_seconds(rays=rays, live_ray_bounces=2.81 * rays, live_misses=rays,
                                 spheres=485)
    assert got["bound"] == "ops"
    assert got["least_s"] == pytest.approx(2.81 * rays * 33950 / 67e12)
    assert got["bytes"] == rays * 17 * 4 + (970 * 17 + 34 * 485) * 4
    sky = roofline.least_seconds(rays=rays, live_ray_bounces=2.81 * rays, live_misses=rays,
                                 spheres=485, has_sky=True)
    assert sky["ops"] - got["ops"] == pytest.approx(15 * rays)
