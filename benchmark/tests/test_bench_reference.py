"""The reference against the program's plain path on the CPU at a tiny
size: the same scenes, the same rays, the same images and the same
gradients. (The tests may import the program; the reference may not.)"""

import numpy as np
import pytest
import torch

from benchmark.jobs.render_frames import tone_map
from benchmark.reference import camera, png, scenes, tracer, train

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SEED = 2**31 + 77   # seeds pass 32 signed bits


@pytest.mark.parametrize("name", ["final_scene", "golden_scene"])
def test_scene_tables_equal_the_program_build(name):
    from rtweekend_tpu_torch.models.builders import build_scene

    ref = scenes.build(name, SEED)
    s = build_scene(name, seed=SEED, device="cpu")
    prog = dict(c0=s.spheres.c0, dc=s.spheres.dc, time0=s.spheres.time0,
                inv_dt=s.spheres.inv_dt, radius=s.spheres.radius, mat_id=s.spheres.mat_id,
                active=s.spheres.active, mtype=s.materials.mtype, tex_id=s.materials.tex_id,
                fuzz=s.materials.fuzz, ior=s.materials.ior, ttype=s.textures.ttype,
                color=s.textures.color, color2=s.textures.color2)
    for k, v in prog.items():
        want = ref[k].astype(np.float32) if ref[k].dtype == np.float64 else ref[k]
        np.testing.assert_array_equal(want, v.numpy().astype(want.dtype), err_msg=k)
    assert ref["n_spheres"] == int(s.spheres.active.sum())


def test_rays_equal_the_program_camera():
    from rtweekend_tpu_torch.ops.camera import generate_rays
    from rtweekend_tpu_torch.render import camera_for_scene

    w, h = 16, 9
    pid = torch.arange(w * h, dtype=torch.int32).repeat_interleave(3)
    sid = torch.arange(3, dtype=torch.int32).repeat(w * h)
    cam = camera.camera((13, 2, 3), (0, 0, 0), 20.0, w / h, 0.1)
    got = camera.rays(cam, w, h, pid, sid, SEED)
    want = generate_rays(camera_for_scene("final_scene", w / h, "cpu"), w, h, pid, sid,
                         SEED & 0xFFFFFFFF)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["final_scene", "golden_scene"])
def test_render_equals_the_program_plain_path(name, tmp_path):
    from rtweekend_tpu_torch.config import SCENE_DEFAULTS, RenderConfig
    from rtweekend_tpu_torch.render import render_image
    from rtweekend_tpu_torch.utils.image import write_png

    w, h, spp, depth = 16, 16, 4, 4
    img, accum = render_image(RenderConfig(name, w, h, spp, depth, seed=SEED), device="cpu")
    write_png(tmp_path / "f.png", img)
    got = png.read(tmp_path / "f.png")
    np.testing.assert_array_equal(got, img)
    d = SCENE_DEFAULTS[name]
    sc = tracer.scene_tensors(scenes.build(name, SEED), "cpu")
    cam = camera.camera(d["look_from"], d["look_at"], d["vfov"], w / h, d["aperture"])
    pid = torch.arange(w * h, dtype=torch.int32).repeat_interleave(spp)
    sid = torch.arange(spp, dtype=torch.int32).repeat(w * h)
    o, dd, t = camera.rays(cam, w, h, pid, sid, SEED)
    counts = {}
    rad = tracer.trace(sc, o, dd, t, pid, sid, SEED, d["background"], depth, counts=counts)
    sums = rad.double().reshape(w * h, spp, 3).sum(1).numpy()
    ref = tone_map(sums, spp).reshape(h, w, 3)[::-1]
    assert np.abs(ref - got.astype(np.int64)).max() <= 1
    np.testing.assert_allclose(sums.reshape(h, w, 3)[::-1], accum.double().numpy(), atol=1e-5)
    assert counts["live_ray_bounces"] >= w * h * spp and counts["live_misses"] > 0


def test_train_step_equals_the_program_step():
    from rtweekend_tpu_torch.config import SCENE_DEFAULTS
    from rtweekend_tpu_torch.models.builders import build_scene
    from rtweekend_tpu_torch.parallel import shard
    from rtweekend_tpu_torch.render import camera_for_scene

    name, w, h, spp, depth = "golden_scene", 24, 16, 2, 5
    d = SCENE_DEFAULTS[name]
    sc = tracer.scene_tensors(scenes.build(name, SEED), "cpu")
    cam = camera.camera(d["look_from"], d["look_at"], d["vfov"], w / h, d["aperture"])
    target = train.mean_image(sc, cam, w, h, spp, depth, d["background"], 5)
    g = torch.Generator().manual_seed(3)
    p0 = {k: sc[k].clone() for k in tracer.PARAMS}
    p0["color"] = p0["color"] * (0.7 + 0.2 * torch.rand(p0["color"].shape, generator=g))
    p0["c0"] = p0["c0"] + 0.02 * torch.randn(p0["c0"].shape, generator=g)
    new_r, loss_r, grads = train.step(sc, p0, cam, target, w, h, spp, depth, d["background"],
                                      SEED, 1.0)
    s = shard.merge_params(build_scene(name, seed=SEED, device="cpu"), dict(p0))
    new_p, loss_p = shard.sharded_train_step(
        s, camera_for_scene(name, w / h, "cpu"), torch.flip(target.reshape(h, w, 3), [0]),
        w, h, spp, depth, d["background"], SEED, lr=1.0, kernel="torch")
    assert loss_r == pytest.approx(float(loss_p), rel=1e-5)
    for k in tracer.PARAMS:
        got = float((p0[k] - new_p[k]).norm())
        assert got == pytest.approx(float(grads[k].norm()), rel=1e-3, abs=1e-9), k
        assert float(grads[k].norm()) > 0.0, k


def test_tf32_rounds_the_mantissa_to_ten_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11 + 2**-20, 3.0e38])
    got = tracer.tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2**-10 and got[2] == 1.0 + 2**-10
    assert torch.equal(tracer.tf32(got), got)
