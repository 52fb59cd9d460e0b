"""Minimal PBRT v3 text-format importer (counterpart of
`fluctus_tpu/scene/loaders/pbrt.py`: the same arrays and materials, and
the same parse-cache files, so a cache written by one package is read by
the other).

Capability parity target (reference: src/scene.cpp:574-813 via pbrt-parser):
triangle-mesh geometry under the full transform stack, the same
material-to-taxonomy mapping (matte→diffuse, plastic/substrate/uber→glossy,
glass→ideal dielectric, mirror→ideal reflection, metal→GGX reflection,
translucent/disney→glossy approximations) with the identical roughness
remap Ns = (1-r)·5000 (src/scene.cpp:729-735), image textures, Include
files, and named materials.

Beyond the reference surface: `sphere` and `disk` shapes are tessellated
into the triangle soup (the reference only logs "Sphere!"/"Disk!",
src/scene.cpp:682-690), and `AreaLightSource "diffuse"` is captured — the
emitting shape's material is tagged emissive (Ke = L, matching the OBJ
loader's `shader emissive` path, src/scene.cpp:186) and, when the emitter
is a quad, its frame is ALSO exported as an area-light hint so the
renderer's single rectangular area light (src/geom.h AreaLight) lights the
scene the way pbrt intended (the reference skips area lights entirely,
src/scene.cpp:620-621). Curves are skipped with a notice. The reference's
PBF binary cache is replaced by an npz cache keyed by scene hash.
"""
from __future__ import annotations

import os
import re

import numpy as np

from fluctus_tpu_torch.core.types import (
    BXDF_DIFFUSE, BXDF_EMISSIVE, BXDF_GGX_ROUGH_REFLECTION, BXDF_GLOSSY,
    BXDF_IDEAL_DIELECTRIC, BXDF_IDEAL_REFLECTION)
from fluctus_tpu_torch.scene.loaders.obj import MtlMaterial

_TOKEN_RE = re.compile(r'"[^"]*"|\[|\]|[^\s\[\]"#]+|#[^\n]*')


def _tokenize(text: str):
    for m in _TOKEN_RE.finditer(text):
        t = m.group(0)
        if t.startswith("#"):
            continue
        yield t


class _Tokens:
    def __init__(self, path):
        self.stack = []
        self._push_file(path)

    def _push_file(self, path):
        with open(path, "r", errors="replace") as f:
            self.stack.append((iter(list(_tokenize(f.read()))),
                               os.path.dirname(path)))

    def next(self):
        while self.stack:
            it, _ = self.stack[-1]
            for t in it:
                return t
            self.stack.pop()
        return None

    @property
    def folder(self):
        return self.stack[-1][1] if self.stack else "."


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n == 0:
        return np.eye(4)
    axis = axis / n
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    x, y, z = axis
    r = np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])
    m = np.eye(4)
    m[:3, :3] = r
    return m


def _convert_roughness(r, remap=True, ru=0.0, rv=0.0):
    """reference: src/scene.cpp convertRoughness — Ns = (1-r)·5000."""
    res = r if r > 0.0 else 0.5 * (ru + rv)
    return (1.0 - res) * (5000.0 if remap else 1.0)


def _uv_sphere(radius: float, rings: int = 16, segs: int = 32):
    """Latitude/longitude tessellation of a radius-r sphere at the origin.
    Returns (pts (V,3), faces (F,3), normals (V,3), uv (V,2))."""
    th = np.linspace(0.0, np.pi, rings + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, segs + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    n = np.stack([np.sin(T) * np.cos(P), np.cos(T),
                  np.sin(T) * np.sin(P)], axis=-1).reshape(-1, 3)
    pts = radius * n
    uv = np.stack([P / (2 * np.pi), 1.0 - T / np.pi],
                  axis=-1).reshape(-1, 2)
    faces = []
    w = segs + 1
    for i in range(rings):
        for j in range(segs):
            a, b = i * w + j, i * w + j + 1
            c, d = (i + 1) * w + j, (i + 1) * w + j + 1
            if i > 0:
                faces.append((a, b, c))
            if i < rings - 1:
                faces.append((b, d, c))
    return pts, np.asarray(faces, np.int64), n, uv


def _disk(radius: float, height: float = 0.0, inner: float = 0.0,
          segs: int = 48):
    """pbrt `disk`: z = height plane, radius/innerradius annulus fan."""
    ph = np.linspace(0.0, 2.0 * np.pi, segs + 1)[:-1]
    outer = np.stack([radius * np.cos(ph), radius * np.sin(ph),
                      np.full(segs, height)], axis=-1)
    faces = []
    if inner > 0.0:
        inn = np.stack([inner * np.cos(ph), inner * np.sin(ph),
                        np.full(segs, height)], axis=-1)
        pts = np.concatenate([outer, inn])
        for j in range(segs):
            k = (j + 1) % segs
            faces += [(j, k, segs + j), (k, segs + k, segs + j)]
    else:
        pts = np.concatenate([outer, [[0.0, 0.0, height]]])
        for j in range(segs):
            faces.append((j, (j + 1) % segs, segs))
    n = np.tile(np.array([0.0, 0.0, 1.0]), (len(pts), 1))
    uv = (pts[:, :2] / max(radius, 1e-9) + 1.0) * 0.5
    return pts, np.asarray(faces, np.int64), n, uv


def _material_from_params(kind: str, p: dict) -> MtlMaterial:
    """PBRT material → 7-type taxonomy (reference: src/scene.cpp:729-812)."""
    def rgb(name, default):
        v = p.get(name, default)
        if np.isscalar(v):
            return (float(v),) * 3
        v = list(np.ravel(v))
        return tuple(float(x) for x in (v * 3)[:3])

    def scalar(name, default):
        v = p.get(name, default)
        return float(np.ravel(v)[0]) if not np.isscalar(v) else float(v)

    m = MtlMaterial(name=kind)
    rough = scalar("roughness", 0.0)
    if kind == "matte":
        m.bsdf_type = BXDF_DIFFUSE
        m.kd = rgb("Kd", 0.5)
    elif kind in ("plastic", "substrate", "uber"):
        m.bsdf_type = BXDF_GLOSSY
        m.kd = rgb("Kd", 0.25)
        m.ks = rgb("Ks", 0.25)
        m.ns = _convert_roughness(rough, True, scalar("uroughness", 0.0),
                                  scalar("vroughness", 0.0))
        m.ni = scalar("index", 1.5)
    elif kind == "glass":
        m.bsdf_type = BXDF_IDEAL_DIELECTRIC
        m.ks = rgb("Kt", 1.0)
        idx = scalar("index", 1.5)
        m.ni = idx if idx > 0 else 1.5
    elif kind == "mirror":
        m.bsdf_type = BXDF_IDEAL_REFLECTION
        m.ks = rgb("Kr", 0.9)
    elif kind == "metal":
        m.bsdf_type = BXDF_GGX_ROUGH_REFLECTION
        eta = rgb("eta", 0.2)
        m.ni = sum(eta) / 3.0
        m.ks = rgb("k", 3.9)
        m.ns = _convert_roughness(rough, True)
    elif kind == "translucent":
        # no transmission lobe in the 7-type taxonomy: approximate like the
        # reference approximates plastic — glossy coat over the diffuse base
        m.bsdf_type = BXDF_GLOSSY
        m.kd = rgb("Kd", 0.25)
        m.ks = rgb("Ks", 0.25)
        m.ns = _convert_roughness(rough, True)
        m.ni = 1.5
    elif kind == "disney":
        m.bsdf_type = BXDF_GLOSSY
        m.kd = rgb("color", 0.5)
        mt = scalar("metallic", 0.0)
        m.ks = tuple(0.08 + 0.9 * mt for _ in range(3))
        m.ns = _convert_roughness(scalar("roughness", 0.5), True)
        m.ni = scalar("eta", 1.5)
    else:
        if kind not in ("matte",):
            print(f"pbrt: unsupported material '{kind}' -> diffuse "
                  f"(reference logs the same, src/scene.cpp:795-807)")
        m.bsdf_type = BXDF_DIFFUSE
        m.kd = rgb("Kd", 0.5)
    m.map_kd = _tex_file(p.get("__tex_Kd"))
    m.map_ks = _tex_file(p.get("__tex_Ks"))
    return m


def _tex_file(tex):
    return tex if isinstance(tex, str) else ""


def load_pbrt(path: str, cache_dir: str | None = "data/pbf_cache"):
    """Parse a .pbrt file. Returns (v0,v1,v2,n0,n1,n2,uv0,uv1,uv2, mat_id,
    materials, area_light) — the array/material contract of the OBJ loader
    (mat_id 0-based with +1 shift applied by the caller convention: here
    ids already index [default]+materials like OBJ's) plus an optional
    quad-emitter hint dict (pos/right/up/normal/size/emission) for the
    renderer's rectangular area light.

    Parsed geometry+materials are cached as an npz keyed by the source
    file's hash — the analogue of the reference's .pbrt -> .pbf binary
    conversion cache (src/scene.cpp:555-620); unlike the reference, the
    cache lives under cache_dir since scene sources may be read-only."""
    if cache_dir:
        cached = _load_cache(path, cache_dir)
        if cached is not None:
            return cached
        result = _parse_pbrt(path)
        _save_cache(path, cache_dir, result)
        return result
    return _parse_pbrt(path)


def _cache_path(path: str, cache_dir: str) -> str:
    from fluctus_tpu_torch.scene.xxh64 import file_hash
    # v2: area-light hint + sphere/disk tessellation entered the format
    return os.path.join(cache_dir, f"pbf_v2_{file_hash(path)}.npz")


def _load_cache(path: str, cache_dir: str):
    import dataclasses
    f = _cache_path(path, cache_dir)
    if not os.path.exists(f):
        return None
    try:
        z = np.load(f, allow_pickle=False)
        n_mats = int(z["n_mats"])
        mats = []
        for i in range(n_mats):
            fields = {}
            for fld in dataclasses.fields(MtlMaterial):
                v = z[f"mat{i}_{fld.name}"]
                if fld.type in ("str", str):
                    fields[fld.name] = str(v)
                elif fld.type in ("tuple", tuple):
                    fields[fld.name] = tuple(float(x) for x in v)
                elif fld.type in ("float", float):
                    fields[fld.name] = float(v)
                else:
                    fields[fld.name] = int(v)
            mats.append(MtlMaterial(**fields))
        arrays = tuple(z[f"a{k}"] for k in range(10))
        al = None
        if "al_pos" in z.files:
            al = {k: z[f"al_{k}"] for k in
                  ("pos", "right", "up", "normal", "size", "emission")}
        print(f"pbrt cache hit: {f}")
        return arrays + (mats, al)
    except Exception as e:  # corrupt/stale cache -> reparse
        print(f"pbrt cache unreadable ({e}); reparsing")
        return None


def _save_cache(path: str, cache_dir: str, result):
    import dataclasses
    os.makedirs(cache_dir, exist_ok=True)
    arrays, mats, al = result[:10], result[10], result[11]
    payload = {f"a{k}": a for k, a in enumerate(arrays)}
    if al is not None:
        for k, v in al.items():
            payload[f"al_{k}"] = np.asarray(v, np.float64)
    payload["n_mats"] = np.int32(len(mats))
    for i, m in enumerate(mats):
        for fld in dataclasses.fields(MtlMaterial):
            payload[f"mat{i}_{fld.name}"] = np.asarray(getattr(m, fld.name))
    # a temporary name in the same directory, then one rename: a reader
    # in another process never sees a half-written file
    dst = _cache_path(path, cache_dir)
    tmp = f"{dst}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, dst)


def _parse_pbrt(path: str):
    toks = _Tokens(path)
    ctm = np.eye(4)
    xform_stack = []
    attr_stack = []
    cur_mat = -1
    cur_emission = None           # active AreaLightSource L (attribute-scoped)
    named_materials: dict[str, int] = {}
    named_textures: dict[str, str] = {}
    materials: list[MtlMaterial] = []
    area_light = None             # quad-emitter hint: dict for the renderer

    tris_v, tris_mat = [], []
    tris_n, tris_uv = [], []

    def read_param_list(first=None):
        """Read PBRT parameter list: sequence of "type name" [values]."""
        params = {}
        tok = first if first is not None else toks.next()
        while tok is not None and tok.startswith('"'):
            decl = tok.strip('"').split()
            pname = decl[-1]
            ptype = decl[0] if len(decl) > 1 else "string"
            nxt = toks.next()
            vals = []
            if nxt == "[":
                while True:
                    t = toks.next()
                    if t == "]" or t is None:
                        break
                    vals.append(t)
            else:
                vals.append(nxt)
            if ptype in ("float", "rgb", "color", "point", "point3", "normal",
                         "vector", "spectrum", "blackbody"):
                params[pname] = [float(v) for v in vals]
            elif ptype == "integer":
                params[pname] = [int(v) for v in vals]
            elif ptype in ("string", "texture"):
                params[pname] = vals[0].strip('"')
                if ptype == "texture":
                    params["__tex_" + pname] = named_textures.get(
                        vals[0].strip('"'), "")
            elif ptype == "bool":
                params[pname] = vals[0].strip('"') == "true"
            else:
                params[pname] = vals
            tok = toks.next()
        return params, tok

    def add_material(kind, params) -> int:
        materials.append(_material_from_params(kind, params))
        return len(materials) - 1

    def shape_material() -> int:
        """Material for the next shape; an active AreaLightSource wraps it
        in an emissive-tagged copy (Ke = L), matching the OBJ loader's
        `shader emissive` convention (src/scene.cpp:186)."""
        nonlocal cur_mat
        if cur_emission is None:
            return cur_mat
        base = (materials[cur_mat] if cur_mat >= 0
                else MtlMaterial(name="arealight"))
        import dataclasses
        em = dataclasses.replace(base, name=base.name + "_emissive",
                                 ke=tuple(cur_emission),
                                 bsdf_type=BXDF_EMISSIVE)
        materials.append(em)
        return len(materials) - 1

    def try_area_light_quad(world_pts):
        """Export a quad emitter as the renderer's rectangular area light
        (pos/right/up/normal/size/emission). First emitter wins; non-quad
        emitters only get the emissive material tag."""
        nonlocal area_light
        if area_light is not None or len(world_pts) != 4:
            return
        c = world_pts.mean(axis=0)
        e0 = world_pts[1] - world_pts[0]
        e1 = world_pts[3] - world_pts[0]
        n = np.cross(e0, e1)
        ln = np.linalg.norm(n)
        if ln <= 0:
            return
        area_light = {
            "pos": c, "right": e0 / np.linalg.norm(e0),
            "up": e1 / np.linalg.norm(e1), "normal": n / ln,
            "size": np.array([np.linalg.norm(e0) * 0.5,
                              np.linalg.norm(e1) * 0.5]),
            "emission": np.asarray(cur_emission, np.float64),
        }

    def emit_mesh(params, mat):
        pts = np.asarray(params.get("P", []), np.float64).reshape(-1, 3)
        idx = np.asarray(params.get("indices", []), np.int64).reshape(-1, 3)
        if len(pts) == 0 or len(idx) == 0:
            return
        homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
        world = (ctm @ homo.T).T[:, :3]
        if cur_emission is not None:
            try_area_light_quad(world)
        nrm = np.asarray(params.get("N", []), np.float64).reshape(-1, 3)
        if len(nrm):
            it = np.linalg.inv(ctm[:3, :3]).T
            nrm = (it @ nrm.T).T
        uv = np.asarray(params.get("uv", params.get("st", [])),
                        np.float64).reshape(-1, 2)
        for f in idx:
            p3 = world[f]
            if len(nrm):
                n3 = nrm[f]
            else:
                fn = np.cross(p3[1] - p3[0], p3[2] - p3[0])
                ln = np.linalg.norm(fn)
                fn = fn / ln if ln > 0 else fn
                n3 = np.stack([fn] * 3)
            u3 = uv[f] if len(uv) else np.zeros((3, 2))
            tris_v.append(p3)
            tris_n.append(n3)
            tris_uv.append(u3)
            tris_mat.append(mat + 1)  # 0 = default material

    tok = toks.next()
    while tok is not None:
        if tok == "Include":
            fname = toks.next().strip('"')
            toks._push_file(os.path.join(toks.folder, fname))
            tok = toks.next()
        elif tok == "LookAt":
            _ = [toks.next() for _ in range(9)]  # camera handled by states
            tok = toks.next()
        elif tok == "Translate":
            t = [float(toks.next()) for _ in range(3)]
            m = np.eye(4)
            m[:3, 3] = t
            ctm = ctm @ m
            tok = toks.next()
        elif tok == "Scale":
            sc = [float(toks.next()) for _ in range(3)]
            ctm = ctm @ np.diag(sc + [1.0])
            tok = toks.next()
        elif tok == "Rotate":
            a = float(toks.next())
            ax = [float(toks.next()) for _ in range(3)]
            ctm = ctm @ _rot(ax, a)
            tok = toks.next()
        elif tok in ("Transform", "ConcatTransform"):
            nxt = toks.next()
            vals = []
            if nxt == "[":
                while True:
                    t = toks.next()
                    if t == "]":
                        break
                    vals.append(float(t))
            m = np.asarray(vals, np.float64).reshape(4, 4).T  # column-major
            ctm = m if tok == "Transform" else ctm @ m
            tok = toks.next()
        elif tok in ("AttributeBegin", "TransformBegin", "ObjectBegin"):
            if tok == "ObjectBegin":
                toks.next()  # name (instancing unsupported; geometry kept)
            xform_stack.append(ctm.copy())
            attr_stack.append((cur_mat, cur_emission))
            tok = toks.next()
        elif tok in ("AttributeEnd", "TransformEnd", "ObjectEnd"):
            if xform_stack:
                ctm = xform_stack.pop()
                cur_mat, cur_emission = attr_stack.pop()
            tok = toks.next()
        elif tok == "Texture":
            name = toks.next().strip('"')
            toks.next()  # type
            toks.next()  # class
            params, tok = read_param_list()
            named_textures[name] = params.get("filename", "")
        elif tok == "Material":
            kind = toks.next().strip('"')
            params, tok = read_param_list()
            cur_mat = add_material(kind, params)
        elif tok == "MakeNamedMaterial":
            name = toks.next().strip('"')
            params, tok = read_param_list()
            kind = params.get("type", "matte")
            named_materials[name] = add_material(kind, params)
        elif tok == "NamedMaterial":
            name = toks.next().strip('"')
            cur_mat = named_materials.get(name, -1)
            tok = toks.next()
        elif tok == "Shape":
            kind = toks.next().strip('"')
            params, tok = read_param_list()
            mat = shape_material()
            if kind == "plymesh":
                from fluctus_tpu_torch.scene.loaders.ply import load_ply
                sub = load_ply(os.path.join(toks.folder,
                                            params["filename"]))
                v0s, v1s, v2s, n0s, n1s, n2s = sub[:6]
                homo = lambda a: (ctm @ np.concatenate(
                    [a, np.ones((len(a), 1))], 1).T).T[:, :3]
                it = np.linalg.inv(ctm[:3, :3]).T
                xn = lambda a: (it @ np.asarray(a, np.float64).T).T
                for i in range(len(v0s)):
                    tris_v.append(np.stack([homo(v0s[i:i+1])[0],
                                            homo(v1s[i:i+1])[0],
                                            homo(v2s[i:i+1])[0]]))
                    tris_n.append(xn(np.stack([n0s[i], n1s[i], n2s[i]])))
                    tris_uv.append(np.zeros((3, 2)))
                    tris_mat.append(mat + 1)
            elif kind == "trianglemesh":
                emit_mesh(params, mat)
            elif kind in ("sphere", "disk"):
                # tessellated (beyond reference: src/scene.cpp:682-690 only
                # logs these)
                if kind == "sphere":
                    r = float(np.ravel(params.get("radius", 1.0))[0])
                    pts, faces, nrm, uv = _uv_sphere(r)
                else:
                    r = float(np.ravel(params.get("radius", 1.0))[0])
                    h = float(np.ravel(params.get("height", 0.0))[0])
                    inner = float(np.ravel(
                        params.get("innerradius", 0.0))[0])
                    pts, faces, nrm, uv = _disk(r, h, inner)
                emit_mesh({"P": pts.reshape(-1),
                           "indices": faces.reshape(-1),
                           "N": nrm.reshape(-1),
                           "uv": uv.reshape(-1)}, mat)
            else:
                print(f"pbrt: skipping shape '{kind}' (reference parity: "
                      f"src/scene.cpp:690-695)")
        elif tok == "AreaLightSource":
            impl = toks.next().strip('"')
            params, tok = read_param_list()
            if impl == "diffuse":
                ll = params.get("L", [1.0, 1.0, 1.0])
                scale = np.ravel(params.get("scale", [1.0]))[0]
                cur_emission = [float(x) * float(scale)
                                for x in (list(np.ravel(ll)) * 3)[:3]]
            else:
                print(f"pbrt: unsupported AreaLightSource '{impl}'")
        elif tok in ("WorldBegin",):
            ctm = np.eye(4)
            tok = toks.next()
        elif tok in ("Camera", "Film", "Sampler", "Integrator", "Filter",
                     "PixelFilter", "LightSource",
                     "Accelerator", "SurfaceIntegrator"):
            toks.next()  # implementation name
            _, tok = read_param_list()
        elif tok in ("WorldEnd", "ReverseOrientation", "ObjectInstance"):
            if tok == "ObjectInstance":
                toks.next()
            tok = toks.next()
        else:
            tok = toks.next()

    if not tris_v:
        raise ValueError(f"{path}: no triangle geometry found")
    v = np.asarray(tris_v, np.float32)
    n = np.asarray(tris_n, np.float32)
    uv = np.asarray(tris_uv, np.float32)
    return (v[:, 0], v[:, 1], v[:, 2], n[:, 0], n[:, 1], n[:, 2],
            uv[:, 0], uv[:, 1], uv[:, 2],
            np.asarray(tris_mat, np.int32), materials, area_light)
