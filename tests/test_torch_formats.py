"""Port against the JAX package on PBRT scenes with their own area light,
through each package's create_session on the CPU, and on image output:

- the PBRT book scene of tests/test_pbrt.py (quad emitter, tessellated
  sphere and disk, glass, metal, translucent) and the cornell proxy
  written as PBRT by fixtures.scene_pbrt with its ceiling light as an
  AreaLightSource quad: both sessions turn use_area_light on and hold the
  same area light, and their 24x24 renders agree as the kitchen's do
  (tests/test_torch_render.py): at least SHARE of the pixels within the
  goldens' RTOL 1e-3 / ATOL 1e-4 and a mean relative error of at most
  MEAN_REL. At these sizes no pixel has differed (share 1.0). The renders
  are the stream's with implicit light hits off: the emitter's triangles
  lie in the area light's own plane, so a ray that reaches the light
  (and a lockstep shadow ray, which ends on the plane) ties with them and
  an ulp of XLA's FMA contraction decides it (ROADMAP Queue 3); the
  stream's shadow rays stop short of the light;
- save_image: a PNG whose pixels equal the PNG PIL writes for the JAX
  package, and an .hdr file byte-equal to the JAX package's."""
import dataclasses

import numpy as np
import pytest
import torch

from fluctus_tpu.core.types import RenderConfig as JaxConfig
from fluctus_tpu.integrators import wavefront as jwf
from fluctus_tpu.io.image import save_image as jax_save_image
from fluctus_tpu.render import driver as jax_driver
from fluctus_tpu_torch.core.types import RenderConfig
from fluctus_tpu_torch.fixtures import scene_pbrt
from fluctus_tpu_torch.integrators import wavefront
from fluctus_tpu_torch.io.image import save_image
from fluctus_tpu_torch.render import driver

from golden_common import ATOL, RTOL
from test_pbrt import PBRT_BOOK_SCENE
from torch_common import REPO, golden_stats

SHARE = 0.995
MEAN_REL = 1e-4
N, SPP, POOL, SEG = 24, 4, 300, 4
CORNELL_LIGHT = {"pos": [0.0, 3.95, 0.0], "right": [1.0, 0.0, 0.0],
                 "up": [0.0, 0.0, -1.0], "normal": [0.0, -1.0, 0.0],
                 "size": [1.0, 1.0],
                 "emission": [15.0, 15.0, 15.0]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_file(name, d):
    if name == "book":
        path = d / "book.pbrt"
        path.write_text(PBRT_BOOK_SCENE)
        return str(path)
    return scene_pbrt(f"{REPO}/assets/cornell_proxy.obj", str(d),
                      CORNELL_LIGHT)


@pytest.mark.parametrize("name,bounces", [("book", 3), ("cornell", 4)])
def test_pbrt_area_light_render_matches_jax(name, bounces, tmp_path,
                                            monkeypatch):
    monkeypatch.chdir(tmp_path)          # the default parse cache lands here
    path = scene_file(name, tmp_path)
    js = jax_driver.create_session(
        path, cfg=JaxConfig(width=N, height=N, max_bounces=bounces,
                            use_env_map=False, sample_impl=False,
                            pool_size=POOL),
        use_sbvh=False, cache_dir=None, state_dir=None)
    s = driver.create_session(
        path, cfg=RenderConfig(width=N, height=N, max_bounces=bounces,
                               use_env_map=False, sample_impl=False,
                               pool_size=POOL),
        use_sbvh=False, cache_dir=None, state_dir=None, device="cpu")
    assert js.cfg.use_area_light and s.cfg.use_area_light
    for f in dataclasses.fields(s.params.area_light):
        np.testing.assert_array_equal(
            getattr(s.params.area_light, f.name).numpy(),
            np.asarray(getattr(js.params.area_light, f.name)), f.name)
    np.testing.assert_array_equal(s.params.camera.pos.numpy(),
                                  np.asarray(js.params.camera.pos))
    want, _ = jwf.render_stream(js.scene, js.params, js.cfg, SPP,
                                segments_per_launch=SEG, deferred=True)
    got, _ = wavefront.render_stream(s.scene, s.params, s.cfg, SPP,
                                     segments_per_launch=SEG, deferred=True)
    want, got = np.asarray(want), got.numpy()
    share, mean_rel = golden_stats(got, want, RTOL, ATOL)
    assert share >= SHARE and mean_rel <= MEAN_REL, (share, mean_rel)
    assert float(want.mean()) > 1e-3             # the file's light lights it
    assert (tmp_path / "data" / "pbf_cache").is_dir()


def frame(seed):
    g = np.random.default_rng(seed)
    img = g.gamma(1.0, 0.6, (9, 13, 3)).astype(np.float32)
    img[0, 0] = [0.0, 1.0, 2e9]          # clipped, 1.0 and huge
    img[1, 1] = [1e-30, 3.0e-5, 0.9999]
    return img


def test_save_png_pixels_equal_jax(tmp_path):
    from PIL import Image
    from fluctus_tpu_torch.scene.png import read_png
    img = frame(1)
    save_image(str(tmp_path / "out" / "port.png"), img)
    jax_save_image(str(tmp_path / "jax.png"), img)
    got = np.asarray(Image.open(tmp_path / "out" / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert got.shape == want.shape == (9, 13, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_png(str(tmp_path / "out" /
                                               "port.png"))[..., :3], want)


def test_save_hdr_bytes_equal_jax(tmp_path):
    img = frame(2)
    save_image(str(tmp_path / "port.HDR"), img)
    jax_save_image(str(tmp_path / "jax.hdr"), img)
    assert (tmp_path / "port.HDR").read_bytes() == \
        (tmp_path / "jax.hdr").read_bytes()


@pytest.mark.parametrize("ext", [".jpg", ".bmp", ".exr", ""])
def test_save_other_formats_raise(tmp_path, ext):
    with pytest.raises(ValueError, match="png and .hdr"):
        save_image(str(tmp_path / f"x{ext}"), frame(3))
