"""Writes the JPEG 2000 files of this directory and j2k.json, with PIL
12.1.0 and the OpenJPEG 2.5.4 it bundles (the machine with the card has
no PIL, so it cannot encode JPEG 2000): run from the repository root,

    python tests/data/j2k/make_j2k_data.py

- kitchen_{floor,floor_n,wood}.jp2: assets/kitchen_*.png as reversible
  JP2 (PIL's defaults: 5/3 wavelet, 6 resolutions, one layer, no
  colour transform), whose RGBA equals the PNG's;
- kitchen_*.irr20.jp2: the same irreversible (9/7, ICT) at rate 20;
- small files PIL writes (64x48 crops of kitchen_wood.png): a raw
  codestream, 16-bit grey, 16x16 tiles, RPCL and CPRL, three layers with
  three resolutions, and a JP2 with a `pclr` palette and `cmap` (PIL's
  P mode, written with fluctus_tpu_torch.fixtures.jp2_bytes);
- opj_*.j2k: codestreams PIL's encoder does not emit, through OpenJPEG's
  own encoder called with ctypes on PIL's bundled libopenjp2 (`encode`
  below): each code-block style (BYPASS, RESET, TERMALL, VCAUSAL, PTERM,
  SEGSYM and all six), progression order changes (POC), SOP and EPH
  markers, a region of interest (RGN), tile-parts, 4:2:0 subsampled
  components (read as sYCC), 12-bit and signed samples.

j2k.json records, for each file, the SHA-256 of PIL's
`Image.open(f).convert("RGBA")` bytes and its shape, and the PIL and
OpenJPEG versions. tests/test_torch_jpeg2000.py imports `encode` to
write more codestreams of its own.
"""
import ctypes
import glob
import hashlib
import io
import json
import os
import sys
import tempfile

import numpy as np
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
LIBS = os.path.join(os.path.dirname(os.path.dirname(Image.__file__)),
                    "pillow.libs")
_P = ctypes.c_void_p
# byte offsets in OpenJPEG 2.5's opj_cparameters_t (x86-64)
_OFF = dict(tile_size_on=0, cp_tx0=4, cp_ty0=8, cp_tdx=12, cp_tdy=16,
            cp_disto_alloc=20, csty=48, prog_order=52, POC=56, numpocs=4792,
            tcp_numlayers=4796, tcp_rates=4800, numresolution=5600,
            cblockw_init=5604, cblockh_init=5608, mode=5612,
            irreversible=5616, roi_compno=5620, roi_shift=5624,
            res_spec=5628, prcw_init=5632, prch_init=5764,
            image_offset_x0=18188, image_offset_y0=18192, tp_on=18696,
            tp_flag=18697, tcp_mct=18698)
_POC_SIZE = 148                      # sizeof(opj_poc_t)
_lib = None


def _openjpeg():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(glob.glob(os.path.join(LIBS, "libopenjp2-*"))[0])
        lib.opj_image_create.restype = _P
        lib.opj_image_create.argtypes = [ctypes.c_uint32, _P, ctypes.c_int]
        lib.opj_create_compress.restype = _P
        lib.opj_create_compress.argtypes = [ctypes.c_int]
        lib.opj_stream_create_default_file_stream.restype = _P
        lib.opj_stream_create_default_file_stream.argtypes = [
            ctypes.c_char_p, ctypes.c_int]
        for name in ("opj_setup_encoder", "opj_start_compress"):
            getattr(lib, name).argtypes = [_P, _P, _P]
        lib.opj_encode.argtypes = [_P, _P]
        lib.opj_end_compress.argtypes = [_P, _P]
        for name in ("opj_stream_destroy", "opj_destroy_codec",
                     "opj_image_destroy"):
            getattr(lib, name).argtypes = [_P]
        _lib = lib
    return _lib


def encode(planes, dx=None, dy=None, prec=8, sgnd=0, colorspace=1,
           irreversible=0, mct=0, mode=0, csty=0, prog=0, layers=(0,),
           numres=3, cblk=(64, 64), tile=None, pocs=(), roi=None, tp=None):
    """A raw codestream of `planes` (one (h, w) int array a component, on
    its own grid) through OpenJPEG's encoder: subsampling `dx`, `dy`;
    `prec` / `sgnd` a value or one a component; `mode` the code-block
    style bits (1 BYPASS, 2 RESET, 4 TERMALL, 8 VCAUSAL, 16 PTERM, 32
    SEGSYM); `csty` 2 SOP, 4 EPH; `prog` 0-4 LRCP..CPRL; `layers` the
    rates (0 lossless); `pocs` (tile, res0, comp0, layer1, res1, comp1,
    order) changes; `roi` (component, shift); `tp` a tile-part flag
    ("R", "L" or "C")."""
    lib = _openjpeg()
    n = len(planes)
    dx, dy = dx or [1] * n, dy or [1] * n
    prec = list(prec) if isinstance(prec, (list, tuple)) else [prec] * n
    sgnd = list(sgnd) if isinstance(sgnd, (list, tuple)) else [sgnd] * n
    parm = (ctypes.c_uint32 * (9 * n))()
    for k, p in enumerate(planes):
        h, w = p.shape
        parm[9 * k:9 * k + 9] = [dx[k], dy[k], w, h, 0, 0, prec[k], prec[k],
                                 sgnd[k]]
    img = lib.opj_image_create(n, parm, colorspace)
    head = (ctypes.c_uint32 * 4).from_address(img)
    head[2] = max((p.shape[1] - 1) * dx[k] + 1 for k, p in enumerate(planes))
    head[3] = max((p.shape[0] - 1) * dy[k] + 1 for k, p in enumerate(planes))
    comps = ctypes.c_void_p.from_address(img + 24).value
    for k, p in enumerate(planes):
        data = ctypes.c_void_p.from_address(comps + 64 * k + 48).value
        np.ctypeslib.as_array((ctypes.c_int32 * p.size).from_address(
            data))[:] = np.asarray(p, np.int32).ravel()
    prm = (ctypes.c_uint8 * 20000)()
    lib.opj_set_default_encoder_parameters(prm)
    a = np.frombuffer(prm, np.uint8)

    def put(name, v, i=0, f="<i4"):
        o = _OFF[name] + 4 * i
        a[o:o + 4] = np.array([v], f).view(np.uint8)

    put("tcp_numlayers", len(layers))
    put("cp_disto_alloc", 1)
    for i, r in enumerate(layers):
        put("tcp_rates", r, i, "<f4")
    for name, v in (("numresolution", numres), ("cblockw_init", cblk[0]),
                    ("cblockh_init", cblk[1]), ("mode", mode),
                    ("irreversible", irreversible), ("csty", csty),
                    ("prog_order", prog), ("numpocs", len(pocs))):
        put(name, v)
    a[_OFF["tcp_mct"]] = mct
    if tile:
        put("tile_size_on", 1)
        put("cp_tdx", tile[0])
        put("cp_tdy", tile[1])
    if roi:
        put("roi_compno", roi[0])
        put("roi_shift", roi[1])
    if tp:
        a[_OFF["tp_on"]] = 1
        a[_OFF["tp_flag"]] = ord(tp)
    for i, (t, r0, c0, l1, r1, c1, order) in enumerate(pocs):
        base = _OFF["POC"] + _POC_SIZE * i
        for off, v in ((0, r0), (4, c0), (8, l1), (12, r1), (16, c1),
                       (32, order), (48, t)):
            a[base + off:base + off + 4] = np.array([v], "<i4").view(
                np.uint8)
    fd, fn = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    codec = lib.opj_create_compress(0)
    stream = lib.opj_stream_create_default_file_stream(fn.encode(), 0)
    ok = (lib.opj_setup_encoder(codec, prm, img)
          and lib.opj_start_compress(codec, img, stream)
          and lib.opj_encode(codec, stream)
          and lib.opj_end_compress(codec, stream))
    lib.opj_stream_destroy(stream)
    lib.opj_destroy_codec(codec)
    lib.opj_image_destroy(img)
    with open(fn, "rb") as f:
        data = f.read()
    os.unlink(fn)
    if not ok:
        raise RuntimeError("OpenJPEG could not encode these options")
    return data


def _pil(im, **kw):
    f = io.BytesIO()
    im.save(f, "JPEG2000", **kw)
    return f.getvalue()


def files() -> dict:
    """{file name: bytes}."""
    sys.path.insert(0, REPO)
    from fluctus_tpu_torch import fixtures
    out = {}
    for name in ("kitchen_floor", "kitchen_floor_n", "kitchen_wood"):
        im = Image.open(os.path.join(REPO, "assets", f"{name}.png"))
        out[f"{name}.jp2"] = _pil(im)
        out[f"{name}.irr20.jp2"] = _pil(im, irreversible=True,
                                        quality_layers=[20], mct=1)
    wood = Image.open(os.path.join(REPO, "assets", "kitchen_wood.png"))
    crop = wood.convert("RGB").crop((0, 0, 64, 48))
    px = np.asarray(crop).astype(np.int32)
    out["small.j2k"] = _pil(crop, no_jp2=True, irreversible=True, mct=1)
    grey16 = Image.fromarray((px[..., 0] * 257 + px[..., 1]).astype(
        np.uint16))
    out["grey16.jp2"] = _pil(grey16)
    out["tiles16.jp2"] = _pil(crop, tile_size=(16, 16), mct=1)
    out["rpcl.jp2"] = _pil(crop, progression="RPCL", precinct_size=(32, 32),
                           codeblock_size=(8, 8))
    out["cprl.j2k"] = _pil(crop.convert("RGBA"), progression="CPRL",
                           no_jp2=True, irreversible=True)
    out["layers3.jp2"] = _pil(crop, quality_layers=[40, 10, 0],
                              num_resolutions=3)
    idx = (px[..., 0] // 32).astype(np.uint8)
    pal = np.stack([np.arange(8) * 32, 255 - np.arange(8) * 32,
                    np.full(8, 99)], -1)
    out["palette.jp2"] = fixtures.jp2_bytes(
        _pil(Image.fromarray(idx), no_jp2=True), 64, 48, 1, pclr=pal,
        cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    rgb = [px[..., k] for k in range(3)]
    for bits, name in ((1, "bypass"), (2, "reset"), (4, "termall"),
                       (8, "vcausal"), (16, "pterm"), (32, "segsym"),
                       (63, "all")):
        out[f"opj_{name}.j2k"] = encode(rgb, mode=bits, layers=(30, 10, 0))
    out["opj_all97.j2k"] = encode(rgb, mode=63, irreversible=1, mct=1,
                                  layers=(30, 10))
    out["opj_poc.j2k"] = encode(rgb, layers=(20, 0), pocs=[
        (1, 0, 0, 2, 2, 3, 0), (1, 2, 0, 2, 3, 3, 2)])
    out["opj_sop_eph.j2k"] = encode(rgb, csty=6, layers=(20, 5, 0),
                                    prog=2, tile=(32, 32))
    out["opj_roi.j2k"] = encode(rgb, roi=(0, 5), irreversible=1, mct=1)
    out["opj_tileparts.j2k"] = encode(rgb, tile=(32, 24), tp="R",
                                      layers=(20, 0))
    ycc = np.asarray(crop.convert("YCbCr")).astype(np.int32)
    out["opj_sycc420.j2k"] = encode(
        [ycc[..., 0], ycc[::2, ::2, 1], ycc[::2, ::2, 2]], dx=[1, 2, 2],
        dy=[1, 2, 2])
    out["opj_12bit.j2k"] = encode([p * 16 + 5 for p in rgb], prec=12,
                                  irreversible=1, mct=1)
    out["opj_signed.j2k"] = encode([p - 128 for p in rgb], sgnd=1)
    return out


def main():
    record = {"pil": Image.__version__,
              "openjpeg": features.version("jpg_2000"), "files": {}}
    for name, data in files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        record["files"][name] = {
            "sha256": hashlib.sha256(rgba.tobytes()).hexdigest(),
            "shape": list(rgba.shape)}
    with open(os.path.join(HERE, "j2k.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
