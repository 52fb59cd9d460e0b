"""Port parity: counter-based RNG, scene hash and PNG decoding.

The RNG must be bit-exact with the JAX package; xxh64 must equal the
`xxhash` package; the PNG decoder must equal PIL's RGBA conversion. The
port itself imports neither xxhash nor PIL: only these tests do."""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import xxhash
from PIL import Image

from fluctus_tpu.core import rng as jrng
from fluctus_tpu_torch.core import rng as trng
from fluctus_tpu_torch.scene.png import decode_png, read_png
from fluctus_tpu_torch.scene.xxh64 import file_hash, xxh64_hexdigest

TEXTURES = ["assets/kitchen_floor.png", "assets/kitchen_floor_n.png",
            "assets/kitchen_wood.png"]


def _grid():
    g = np.random.default_rng(3)
    pix = np.concatenate([np.arange(64), g.integers(0, 1 << 20, 192),
                          [0xFFFFFFFF, 0x80000000]]).astype(np.uint32)
    samp = np.array([0, 1, 7, 15, 16, 1023, 0x7FFFFFFF, 0xFFFFFFFF],
                    np.uint32)
    bounce = np.arange(10, dtype=np.uint32)
    stream = np.array([0, 4, 9, 12, 15], np.uint32)
    return np.meshgrid(pix, samp, bounce, stream, indexing="ij")


def _i32(a):
    return torch.from_numpy(a.astype(np.uint32).view(np.int32).copy())


def test_pcg4d_bits_exact():
    p, s, b, st = (x.reshape(-1) for x in _grid())
    want = np.asarray(jrng.hash4(p, s, b, st))
    got = trng.hash4(_i32(p), _i32(s), _i32(b), _i32(st))
    got = np.stack([g.numpy().view(np.uint32) for g in got], axis=-1)
    np.testing.assert_array_equal(got, want)


def test_uniform_bit_exact():
    p, s, b, st = (x.reshape(-1) for x in _grid())
    want = jrng.uniform(p, s, b, st)
    got = trng.uniform(_i32(p), _i32(s), _i32(b), _i32(st))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_uniform_python_int_counters():
    """Scalar counters broadcast like jnp.uint32 scalars."""
    pix = np.arange(100, dtype=np.uint32)
    want = np.asarray(jrng.uniform(pix, jnp.uint32(5), jnp.uint32(3), 7))
    got = trng.uniform(_i32(pix), 5, 3, 7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 15, 31, 32, 33, 63, 100,
                               1000, 4099])
@pytest.mark.parametrize("seed", [0, 1, 2 ** 64 - 1])
def test_xxh64_matches_xxhash(n, seed):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    assert xxh64_hexdigest(data, seed) == xxhash.xxh64(
        data, seed=seed).hexdigest()


def test_kitchen_hash_keys_saved_state():
    with open("assets/kitchen_proxy.obj", "rb") as f:
        want = xxhash.xxh64(f.read()).hexdigest()
    assert file_hash("assets/kitchen_proxy.obj") == want \
        == "c68e332cfae81cc6"


@pytest.mark.parametrize("path", TEXTURES)
def test_png_matches_pil_on_kitchen_textures(path):
    np.testing.assert_array_equal(
        read_png(path), np.asarray(Image.open(path).convert("RGBA")))


def _png_bytes(mode, ch):
    g = np.random.default_rng(11)
    base = g.integers(0, 256, (37, 53, ch), dtype=np.uint8)
    # smooth ramps make the Sub/Up/Average/Paeth filters worth choosing
    base[:18] = (np.arange(53)[None, :, None] * 3 + np.arange(18)[:, None,
                                                                  None])
    buf = io.BytesIO()
    Image.fromarray(base[..., 0] if ch == 1 else base, mode).save(
        buf, "PNG", optimize=True)    # the encoder picks among all filters
    return buf.getvalue()


@pytest.mark.parametrize("mode,ch", [("RGB", 3), ("RGBA", 4)])
def test_png_matches_pil_on_all_filters(mode, ch):
    data = _png_bytes(mode, ch)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(decode_png(data), want)


@pytest.mark.parametrize("mode,ch", [("L", 1), ("LA", 2)])
def test_png_refuses_other_colour_types(mode, ch):
    """Grey and grey+alpha PNGs decode as PIL converts them (every PNG
    colour type does since the decoder took them all,
    tests/test_torch_textures.py); what is refused is a colour type or
    depth the PNG standard does not define."""
    import struct
    import zlib
    from fluctus_tpu_torch.scene.imageformat import UnsupportedImage
    data = _png_bytes(mode, ch)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(decode_png(data), want)
    ihdr = bytearray(data[16:29])
    ihdr[8:10] = bytes([8, 5])               # colour type 5: undefined
    bad = (data[:16] + bytes(ihdr)
           + struct.pack(">I", zlib.crc32(b"IHDR" + bytes(ihdr)))
           + data[33:])
    with pytest.raises(UnsupportedImage, match="colour type 5"):
        decode_png(bad)
