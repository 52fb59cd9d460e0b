"""The port stands alone: with jax, flax, optax, orbax, xxhash, PIL,
zstandard and fluctus_tpu made unimportable, fluctus_tpu_torch (the stream, the
benchmark harness, the bench, the probes and their scripts included) and
chip_smoke.py import, the kitchen renders on the CPU with its textures
through the lockstep and the stream, the luxball renders env-lit from an
HDR the port writes and two optimizer steps (with their checkpoint) run
on it, a brute-chunk forest and a treelet forest build and traverse
under both of their schedulers, a packet call (backend "pallas") runs,
a 2-shard mesh renders through both integrators, the packet forest
builds and traverses through both of its walks,
the denoised, progressive and preview renders, picking, the saved state,
the XLA backends ("jnp", "packed", "wide") and the command line run, and
the texture decoders (JPEG 2000, the TIFF codecs, AVIF) read their files. The
native decoders include only the C++ standard library. The machine with
the card has none of those packages."""
import os
import re
import subprocess
import sys

from torch_common import REPO

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "xxhash", "PIL",
           "zstandard", "fluctus_tpu")

_CHILD = r'''
import importlib, pkgutil, sys
BLOCKED = %r

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"{name} is blocked in this test")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
import fluctus_tpu_torch
for m in pkgutil.walk_packages(fluctus_tpu_torch.__path__,
                               "fluctus_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke          # module level only; main() is not run
import torch
from fluctus_tpu_torch.core.types import RenderConfig
from fluctus_tpu_torch.render import driver
cfg = RenderConfig(width=8, height=8, max_bounces=2, use_area_light=True,
                   use_env_map=False)
s = driver.create_session("assets/kitchen_proxy.obj", cfg=cfg,
                          state_dir="data/states", auto_frame=False,
                          device="cpu")
assert int((s.scene.materials.map_kd >= 0).sum()) == 2, "map_Kd lost"
assert int((s.scene.materials.map_n >= 0).sum()) == 1, "map_bump lost"
assert s.host_scene.hash == "c68e332cfae81cc6"
img = driver.render(s, 1)
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
assert float(img.sum()) > 0.0
import fluctus_tpu_torch.bench
from fluctus_tpu_torch.integrators import wavefront
from fluctus_tpu_torch.ops import probes
from fluctus_tpu_torch.render import benchmark
from fluctus_tpu_torch.scripts import measure_mfu, probe_launch_floor
img = driver.render(s, 2, integrator="stream")
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
assert float(img.sum()) > 0.0
assert torch.equal(probes.copy_plus_one(torch.zeros(8, 128)),
                   torch.ones(8, 128))
import os
from fluctus_tpu_torch.accel.forest import build_brute_forest
from fluctus_tpu_torch.convert import brute_from_numpy
from fluctus_tpu_torch.ops import traverse_brute, traverse_stack
h = s.host_scene
hb = build_brute_forest(h.v0, h.v1, h.v2, target_tris=4096)
bf = brute_from_numpy({f: getattr(hb, f) for f in
                       ("tris", "boxes", "boxes_t", "tboxes", "tile")}, "cpu")
o = torch.tensor([[0.5, 1.0, 0.5]]).repeat(256, 1)
d = torch.nn.functional.normalize(torch.randn(256, 3,
                                  generator=torch.Generator().manual_seed(1)))
ref = traverse_stack.traverse_closest(s.scene.wbvh, o, d, 3.4e38)
assert int((ref.prim >= 0).sum()) > 200
blocked = traverse_stack.traverse_any(s.scene.wbvh, o, d, 0.5)
assert 0 < int(blocked.sum()) < 256
for sched in ("vlist", "rounds"):
    os.environ["FLUCTUS_BRUTE_SCHED"] = sched
    r = traverse_brute.traverse_closest(bf, o, d, 3.4e38)
    assert bool((r.prim == ref.prim).all()), sched
    assert torch.equal(traverse_brute.traverse_any(bf, o, d, 0.5), blocked)
from fluctus_tpu_torch.accel.forest import build_host_forest
from fluctus_tpu_torch.core.types import ForestTables
from fluctus_tpu_torch.ops import traverse_forest, traverse_pallas
hf = build_host_forest(h.v0, h.v1, h.v2, target_tris=4096)
ft = ForestTables(*(torch.from_numpy(x) for x in (hf.nodes, hf.leaves,
                                                  hf.boxes)),
                  lvl=hf.lvl, leaf_width=hf.leaf_width)
for mode in ("workqueue", "blocksched"):
    r = traverse_forest.traverse_closest(ft, o, d, 3.4e38, mode=mode)
    assert torch.equal(r.t, ref.t), mode
    assert torch.equal(traverse_forest.traverse_any(ft, o, d, 0.5, mode=mode),
                       blocked)
r = traverse_pallas.traverse_closest(s.scene.wbvh, o, d, 3.4e38)
assert torch.equal(r.t, ref.t)
assert torch.equal(traverse_pallas.traverse_any(s.scene.wbvh, o, d, 0.5),
                   blocked)
from fluctus_tpu_torch.parallel import mesh as pmesh
from fluctus_tpu_torch.scene import scene as scene_mod
m2 = pmesh.make_mesh(["cpu", "cpu"])
assert torch.equal(pmesh.render_sharded(s.scene, s.params, s.cfg, 1, m2),
                   driver.lockstep.render(s.scene, s.params, s.cfg, 1))
img2, cnt = pmesh.render_stream_sharded(s.scene, s.params, s.cfg, 1, m2)
assert tuple(cnt.shape) == (2, 3) and bool(torch.isfinite(img2).all())
scene_mod.FOREST_TABLE_BYTES, scene_mod.FOREST_CHUNK_BYTES = 0, 64 << 10
os.environ["FLUCTUS_PACKET_FOREST"] = "1"
pf = h.to_device("cpu")
del os.environ["FLUCTUS_PACKET_FOREST"]
assert len(pf.wforest) > 1
for mod in (traverse_stack, traverse_pallas):
    r = mod.traverse_closest_forest(pf.wforest, pf.wforest_maps, o, d, 3.4e38)
    assert torch.allclose(r.t, ref.t, rtol=1e-5), mod
    assert torch.equal(mod.traverse_any_forest(pf.wforest, o, d, 0.5),
                       blocked), mod
import tempfile
from fluctus_tpu_torch.fixtures import sky_env
from fluctus_tpu_torch.io.hdr import read_hdr, write_hdr
from fluctus_tpu_torch.ops import envmap as env_ops
env_path = os.path.join(tempfile.mkdtemp(), "sky.hdr")
write_hdr(env_path, sky_env(32, 16, seed=1, sun_texels=1.0))
assert read_hdr(env_path).shape == (16, 32, 3)
cfg = RenderConfig(width=8, height=8, max_bounces=2)
e = driver.create_session("assets/luxball_proxy.obj", env_path, cfg,
                          state_dir=None, device="cpu")
assert e.cfg.use_env_map and tuple(e.scene.envmap.image.shape) == (16, 32, 3)
for integ in ("lockstep", "stream"):
    img = driver.render(e, 1, integrator=integ)
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0.0, integ
from fluctus_tpu_torch.render.optimize import run_optimization
tgt = os.path.join(tempfile.mkdtemp(), "t.hdr")
write_hdr(tgt, (driver.render(e, 1, integrator="lockstep") * 0.5).numpy())
diff, hist = run_optimization(e, tgt, steps=2, spp=1, log_every=100,
                              out_dir=os.path.dirname(tgt),
                              checkpoint_every=1, diff_keys=("kd",
                                                             "env_image"))
assert len(hist) == 2 and all(h == h for h in hist), hist
from fluctus_tpu_torch.render import state
den = driver.render_denoised(e, 1, integrator="lockstep")
assert den.shape == (8, 8, 3) and bool(torch.isfinite(den).all())
prog = driver.ProgressiveRender(e, samples_per_launch=1)
prog.add(1)
assert prog.add(1) == 2 and torch.equal(
    prog.image(), driver.lockstep.render(e.scene, e.params, e.cfg, 2))
assert driver.render_preview(e, 1).shape == (8, 8, 3)
t, prim = state.pick(s.scene, s.params, s.cfg, 0.5, 0.5)
assert prim >= 0 and t > 0.0
sd = tempfile.mkdtemp()
state.save_state(s.params, "h", state_dir=sd)
assert torch.equal(state.load_state(e.params, "h", state_dir=sd).camera.pos,
                   s.params.camera.pos)
for be in ("jnp", "packed", "wide"):
    b = driver.create_session("assets/cornell_proxy.obj",
                              cfg=RenderConfig(width=8, height=8,
                                               backend=be),
                              state_dir=None, cache_dir=None, device="cpu")
    assert driver.render(b, 1).shape == (8, 8, 3), be
from fluctus_tpu_torch.cli import main as cli_main
out = os.path.join(tempfile.mkdtemp(), "c.png")
cli_main(["render", "assets/cornell_proxy.obj", "-x", "8", "-y", "8", "-s",
          "1", "--area-light", "--cache-dir", "", "-o", out,
          "--device", "cpu"])
assert os.path.getsize(out) > 0
leaked = [m for m in sys.modules
          if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
print("ISOLATED-OK")
'''


def test_port_imports_and_renders_without_jax_stack():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD % (BLOCKED, REPO)], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED-OK" in proc.stdout


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|orbax|xxhash|PIL|"
    r"zstandard|fluctus_tpu)\b"
    r"(?!_torch)", re.M)


def test_sources_name_no_jax_stack_import():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "fluctus_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = {}
    for path in files:
        with open(path) as f:
            hits = _IMPORT.findall(f.read())
        if hits:
            bad[os.path.relpath(path, REPO)] = hits
    assert not bad, bad


def test_native_decoders_use_the_standard_library_only():
    """The C++ decoders (JPEG, WebP, BCn, JPEG 2000, Zstandard, CCITT, AV1,
    the scene hash) include no header but the C++ standard library's: no
    OpenJPEG, libzstd, libtiff, libjpeg, dav1d or libavif is linked."""
    native = os.path.join(REPO, "fluctus_tpu_torch", "scene", "native")
    names = sorted(os.listdir(native))
    for want in ("j2k.cpp", "zstd.cpp", "ccitt.cpp", "av1.cpp"):
        assert want in names
    allowed = re.compile(r"<(c[a-z]+|[a-z_]+|stdint\.h|string\.h|"
                         r"stdlib\.h|math\.h)>")
    for name in names:
        with open(os.path.join(native, name)) as f:
            incs = re.findall(r"^#include\s+(\S+)", f.read(), re.M)
        assert incs and all(allowed.fullmatch(i) for i in incs), (name, incs)


_TEX_CHILD = r'''
import sys
BLOCKED = %r

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"{name} is blocked in this test")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
import numpy as np
from fluctus_tpu_torch.scene.textures import TexturePool
for name in %r:
    pool = TexturePool()
    i = pool.try_import(%r + "/" + name, name)
    want = np.load(%r + "/" + name + ".npy")
    assert i == 0 and np.array_equal(pool.textures[0].rgba, want), name
leaked = [m for m in sys.modules
          if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
print("DECODED-OK")
'''


def test_port_decodes_textures_without_pil(tmp_path):
    """The image decoders (PNG, JPEG baseline and progressive with its g++
    build, BMP, TGA, GIF, TIFF (LZW, JPEG, CMYK), PPM, DDS with its g++
    build (DXT5, BC6H unsigned and signed), ICO, PCX, QOI, SGI, DIB, MSP,
    XBM, PSD CMYK and Lab, IM (RGB and YCC), SPIDER, BLP, ICNS, WebP
    lossless, lossy and lossy with alpha from tests/data/webp with its
    g++ build, JPEG 2000 reversible, irreversible, with every code-block
    style and with a palette from tests/data/j2k, TIFF G4, G3 2D,
    Zstandard, LZMA, old-style JPEG and YCbCr from tests/data/tiff, and
    AVIF (lossless 4:2:0, lossy, premultiplied alpha, screen content with
    intra block copy, an avis sequence) from tests/data/avif, with their
    g++ builds) run with PIL and zstandard unimportable and give the rows
    PIL gives."""
    import numpy as np
    from PIL import Image
    g = np.random.default_rng(0)
    img = Image.fromarray(g.integers(0, 256, (9, 13, 3), dtype=np.uint8))
    names = []
    for name, im, kw in (("a.png", img.convert("LA"), {}),
                         ("i.dds", img.convert("RGBA"),
                          dict(pixel_format="DXT5")),
                         ("j.ico", img.convert("RGBA").resize((16, 16)),
                          dict(bitmap_format="bmp")),
                         ("b.jpg", img, dict(quality=80,
                                             subsampling="4:2:0")),
                         ("c.bmp", img.quantize(9), {}),
                         ("d.tga", img.convert("RGBA"),
                          dict(compression="tga_rle")),
                         ("e.jpg", img, dict(progressive=True)),
                         ("f.gif", img.quantize(7), dict(interlace=True)),
                         ("g.tif", img, dict(compression="tiff_lzw")),
                         ("h.ppm", img, {}),
                         ("k.pcx", img, {}), ("l.qoi", img, {}),
                         ("m.sgi", img, {}), ("n.dib", img.quantize(9), {}),
                         ("o.msp", img.convert("1"), {}),
                         ("p.xbm", img.convert("1"), {}),
                         ("q.tif", img, dict(compression="jpeg")),
                         ("r.tif", img.convert("CMYK"),
                          dict(compression="tiff_deflate")),
                         ("s.im", img, {}),
                         ("t.spi", img.convert("F"), dict(format="SPIDER")),
                         ("u.blp", img.quantize(9), {}),
                         ("v.icns", img.resize((16, 16)), {})):
        im.save(tmp_path / name, **kw)
        rgba = np.asarray(Image.open(tmp_path / name).convert("RGBA"))
        np.save(tmp_path / f"{name}.npy", np.ascontiguousarray(rgba[::-1]))
        names.append(name)
    from fluctus_tpu_torch import fixtures
    img.convert("YCbCr").save(tmp_path / "w.im")
    files = {f"s{mode}.psd": fixtures.psd_bytes(mode, 13, 9, True)
             for mode in ("CMYK", "LAB")}
    files["x.dds"] = fixtures.dds_bytes("BC6H", 12, 8, seed=2)
    files["y.dds"] = fixtures.dds_bytes("BC6HS", 12, 8, seed=3)
    for sub, name in (("webp", "kitchen_wood.lossless.webp"),
                      ("webp", "kitchen_floor.q80.webp"),
                      ("webp", "wood_alpha.q80.webp"),
                      ("j2k", "kitchen_floor_n.jp2"),
                      ("j2k", "kitchen_wood.irr20.jp2"),
                      ("j2k", "opj_all.j2k"), ("j2k", "palette.jp2"),
                      ("tiff", "ccitt_g4.tif"), ("tiff", "ccitt_g3_2d.tif"),
                      ("tiff", "zstd.tif"), ("tiff", "lzma_pred2.tif"),
                      ("tiff", "ojpeg_tables.tif"),
                      ("tiff", "ycbcr22_deflate.tif"),
                      ("avif", "kitchen_wood.avif"),
                      ("avif", "kitchen_floor_n.avif"),
                      ("avif", "alpha_prem.avif"), ("avif", "screen.avif"),
                      ("avif", "sequence.avif")):
        with open(os.path.join(REPO, "tests", "data", sub, name),
                  "rb") as f:
            files[name] = f.read()
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    for name in ("w.im", *files):
        rgba = np.asarray(Image.open(tmp_path / name).convert("RGBA"))
        np.save(tmp_path / f"{name}.npy", np.ascontiguousarray(rgba[::-1]))
        names.append(name)
    d = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", _TEX_CHILD % (BLOCKED, REPO, names, d, d)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "DECODED-OK" in proc.stdout


_SWEEP_CHILD = r'''
import os, sys, tempfile
BLOCKED = %r

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"{name} is blocked in this test")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
import numpy as np
from fluctus_tpu_torch.accel import cpu_ref
from fluctus_tpu_torch.scripts import run_protocol
g = np.random.default_rng(0)
v0 = g.uniform(-1, 1, (50, 3))
o = np.zeros((20, 3))
d = g.normal(size=(20, 3))
t, prim, u, v = cpu_ref.intersect_closest(v0, v0 + 0.5, v0 - 0.5 * d[:1],
                                          o, d)
assert prim.dtype == np.int32 and t.shape == (20,)
cornell = os.path.join(%r, "assets", "cornell_proxy.obj")
os.chdir(tempfile.mkdtemp())
run_protocol.SIZE = 8
run_protocol.SCENES = [("cornell", cornell, None, True, 1)]
summary = run_protocol.main(["--duration", "0.05", "--device", "cpu"])
assert summary[0]["scene"] == "cornell"
assert os.path.exists("out/protocol_summary.txt")
leaked = [m for m in sys.modules
          if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
print("SWEEP-OK")
'''


def test_protocol_sweep_and_oracle_stand_alone():
    """scripts/run_protocol.py (a sweep on the CPU) and accel/cpu_ref.py
    run with jax, PIL and fluctus_tpu unimportable."""
    proc = subprocess.run(
        [sys.executable, "-c", _SWEEP_CHILD % (BLOCKED, REPO, REPO)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SWEEP-OK" in proc.stdout
