"""PBF binary scene container (pbrt-parser style; counterpart of
`fluctus_tpu/scene/loaders/pbf.py`, the same bytes written and the same
arrays read, so a .pbf written by either package loads in the other).

The reference opens `.pbf` files directly (src/scene.cpp:573-620
``Scene::loadPBFModel`` via ``pbrt::Scene::loadFrom``) and converts
`.pbrt` text to `.pbf` once as a binary cache
(``Scene::convertPBRTModel``, src/scene.cpp:567-571). This module gives
the same capability: ``load_pbf`` ingests a binary scene container with
the pbrt-parser architecture — a format-tag header followed by
size-prefixed entity blocks, entities referenced by their emit-order ID
— and ``convert_pbrt_to_pbf`` produces one from `.pbrt` text.

Framing (little-endian throughout, matching pbrt-parser's
BinaryWriter/BinaryReader design):

  header:  uint32 formatTag = (FORMAT_MAJOR << 16) | FORMAT_MINOR
  blocks:  uint64 size, payload[size]
  payload: int32 typeTag, entity fields
  refs:    int32 entity ID in emit order (first block = 0); -1 = null
  string:  int32 length + utf-8 bytes
  vector:  uint64 count + raw element data

The last entity in the file is the Scene root (pbrt-parser writes the
root last: every referenced entity is serialized before its referrer).
Unknown typeTags are skipped whole-block — the size prefix makes every
reader forward-compatible with entity types it does not know.

The snapshot ships no `.pbf` sample and the pbrt-parser submodule is
empty (SURVEY §2.3), so byte-level identity with upstream pbrt-parser
cannot be verified here; field layouts for the entity subset this
renderer consumes (triangle meshes, the PBRT material taxonomy, image
textures, area lights, single-level instances) follow the upstream
architecture and are locked by roundtrip tests. Files written by a
different pbf dialect fail with a clear version/tag error rather than
garbage geometry.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.loaders.obj import MtlMaterial

FORMAT_MAJOR = 1
FORMAT_MINOR = 1
FORMAT_TAG = (FORMAT_MAJOR << 16) | FORMAT_MINOR

# entity type tags (pbrt-parser's enum groups: scene graph, materials,
# textures, shapes)
TYPE_SCENE = 1
TYPE_OBJECT = 2
TYPE_INSTANCE = 4
TYPE_MATERIAL = 10
TYPE_IMAGE_TEXTURE = 31
TYPE_TRIANGLE_MESH = 40
TYPE_AREA_LIGHT = 45


class _Writer:
    def __init__(self):
        self.blocks: list[bytes] = []
        self.ids: dict[int, int] = {}    # id(obj) -> entity ID

    def emit(self, payload: bytes) -> int:
        self.blocks.append(payload)
        return len(self.blocks) - 1

    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(struct.pack("<I", FORMAT_TAG))
            for b in self.blocks:
                f.write(struct.pack("<Q", len(b)))
                f.write(b)


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return struct.pack("<i", len(raw)) + raw


def _pack_vec(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    return struct.pack("<Q", a.shape[0]) + a.tobytes()


class _Reader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < 4:
            raise ValueError(f"{path}: not a pbf file (too short)")
        (tag,) = struct.unpack_from("<I", data, 0)
        if (tag >> 16) != FORMAT_MAJOR:
            raise ValueError(
                f"{path}: pbf format {tag >> 16}.{tag & 0xFFFF} not "
                f"supported (reader speaks {FORMAT_MAJOR}.x)")
        self.entities: list[object] = []
        off = 4
        while off + 8 <= len(data):
            (size,) = struct.unpack_from("<Q", data, off)
            off += 8
            if off + size > len(data):
                raise ValueError(f"{path}: truncated entity block at "
                                 f"offset {off}")
            self.entities.append(self._parse(data[off:off + size], path))
            off += size

    # -- field readers over one payload
    def _parse(self, buf: bytes, path: str):
        pos = [4]
        (tag,) = struct.unpack_from("<i", buf, 0)

        def u64():
            (v,) = struct.unpack_from("<Q", buf, pos[0])
            pos[0] += 8
            return v

        def i32():
            (v,) = struct.unpack_from("<i", buf, pos[0])
            pos[0] += 4
            return v

        def f32s(n):
            v = struct.unpack_from(f"<{n}f", buf, pos[0])
            pos[0] += 4 * n
            return v

        def string():
            n = i32()
            s = buf[pos[0]:pos[0] + n].decode("utf-8")
            pos[0] += n
            return s

        def vec(dtype, width):
            n = u64()
            nbytes = n * width * np.dtype(dtype).itemsize
            a = np.frombuffer(buf, dtype, count=n * width,
                              offset=pos[0]).reshape(n, width)
            pos[0] += nbytes
            return a

        if tag == TYPE_TRIANGLE_MESH:
            return {"tag": tag, "material": i32(), "area_light": i32(),
                    "vertex": vec(np.float32, 3),
                    "normal": vec(np.float32, 3),
                    "texcoord": vec(np.float32, 2),
                    "index": vec(np.int32, 3)}
        if tag == TYPE_MATERIAL:
            kind = string()
            nparam = i32()
            params = {}
            for _ in range(nparam):
                pname = string()
                ptype = i32()
                if ptype == 0:
                    params[pname] = list(f32s(i32()))
                else:
                    params[pname] = string()
            return {"tag": tag, "kind": kind, "params": params}
        if tag == TYPE_IMAGE_TEXTURE:
            return {"tag": tag, "filename": string()}
        if tag == TYPE_AREA_LIGHT:
            return {"tag": tag, "L": f32s(3)}
        if tag == TYPE_OBJECT:
            name = string()
            shapes = [i32() for _ in range(i32())]
            insts = [i32() for _ in range(i32())]
            return {"tag": tag, "name": name, "shapes": shapes,
                    "instances": insts}
        if tag == TYPE_INSTANCE:
            xfm = np.asarray(f32s(12), np.float64).reshape(4, 3).T  # l, p
            return {"tag": tag, "object": i32(), "xfm": xfm}
        if tag == TYPE_SCENE:
            return {"tag": tag, "world": i32()}
        return {"tag": tag, "_skipped": True}


# ---------------------------------------------------------------------------
# material <-> generic param dict (shares the PBRT text taxonomy mapping)

def _material_payload(kind: str, params: dict) -> bytes:
    out = [struct.pack("<i", TYPE_MATERIAL), _pack_str(kind),
           struct.pack("<i", len(params))]
    for name, v in params.items():
        out.append(_pack_str(name))
        if isinstance(v, str):
            out.append(struct.pack("<i", 1))
            out.append(_pack_str(v))
        else:
            vals = [float(x) for x in np.ravel(v)]
            out.append(struct.pack("<i", 0))
            out.append(struct.pack("<i", len(vals)))
            out.append(struct.pack(f"<{len(vals)}f", *vals))
    return b"".join(out)


def _mtl_to_pbf(m: MtlMaterial) -> tuple[str, dict]:
    """Project an MtlMaterial onto a pbrt material kind + params so the
    pbf stores taxonomy-portable data (reverse of _material_from_params)."""
    from fluctus_tpu_torch.core.types import (
        BXDF_EMISSIVE, BXDF_GGX_ROUGH_REFLECTION, BXDF_GLOSSY,
        BXDF_IDEAL_DIELECTRIC, BXDF_IDEAL_REFLECTION)
    p: dict = {}
    if m.bsdf_type == BXDF_GLOSSY:
        kind = "plastic"
        p["Kd"] = list(m.kd)
        p["Ks"] = list(m.ks)
        p["roughness"] = [1.0 - m.ns / 5000.0]
        p["index"] = [m.ni]
    elif m.bsdf_type == BXDF_IDEAL_DIELECTRIC:
        kind = "glass"
        p["Kt"] = list(m.ks)
        p["index"] = [m.ni]
    elif m.bsdf_type == BXDF_IDEAL_REFLECTION:
        kind = "mirror"
        p["Kr"] = list(m.ks)
    elif m.bsdf_type == BXDF_GGX_ROUGH_REFLECTION:
        kind = "metal"
        p["eta"] = [m.ni] * 3
        p["k"] = list(m.ks)
        p["roughness"] = [1.0 - m.ns / 5000.0]
    else:  # diffuse / emissive base
        kind = "matte"
        p["Kd"] = list(m.kd)
    if m.bsdf_type == BXDF_EMISSIVE:
        p["__Ke"] = list(m.ke)
    if m.map_kd:
        p["__tex_Kd"] = m.map_kd
    if m.map_ks:
        p["__tex_Ks"] = m.map_ks
    return kind, p


def _pbf_to_mtl(kind: str, params: dict) -> MtlMaterial:
    from fluctus_tpu_torch.core.types import BXDF_EMISSIVE
    from fluctus_tpu_torch.scene.loaders.pbrt import _material_from_params
    m = _material_from_params(kind, dict(params))
    ke = params.get("__Ke")
    if ke is not None and any(float(x) > 0 for x in ke):
        m.ke = tuple(float(x) for x in ke)
        m.bsdf_type = BXDF_EMISSIVE
    tex = params.get("__tex_Kd")
    if isinstance(tex, str):
        m.map_kd = tex
    tex = params.get("__tex_Ks")
    if isinstance(tex, str):
        m.map_ks = tex
    return m


# ---------------------------------------------------------------------------
# public API

def write_pbf(path: str, v0, v1, v2, n0, n1, n2, uv0, uv1, uv2,
              mat_id, materials: list[MtlMaterial], area_light=None):
    """Serialize loader-contract arrays as a .pbf container. Triangles are
    grouped by material into indexed TriangleMesh entities (shared
    vertices are NOT re-welded — the soup stays a soup, matching what the
    reference's makeSingleLevel flattening feeds the uploader).
    ``mat_id`` follows the loader contract: 0 = default material, k >= 1
    indexes ``materials[k-1]``."""
    w = _Writer()
    mat_ids_pbf = []
    for m in materials:
        kind, params = _mtl_to_pbf(m)
        mat_ids_pbf.append(w.emit(_material_payload(kind, params)))

    mat_id = np.asarray(mat_id, np.int32)
    shape_ids = []
    for mi in np.unique(mat_id):
        sel = mat_id == mi
        nsel = int(np.count_nonzero(sel))
        v = np.stack([np.asarray(v0)[sel], np.asarray(v1)[sel],
                      np.asarray(v2)[sel]], axis=1).reshape(-1, 3)
        n = np.stack([np.asarray(n0)[sel], np.asarray(n1)[sel],
                      np.asarray(n2)[sel]], axis=1).reshape(-1, 3)
        uv = np.stack([np.asarray(uv0)[sel], np.asarray(uv1)[sel],
                       np.asarray(uv2)[sel]], axis=1).reshape(-1, 2)
        idx = np.arange(3 * nsel, dtype=np.int32).reshape(-1, 3)
        al_ref = -1
        mat = materials[mi - 1] if mi >= 1 else None
        if mat is not None and any(k > 0 for k in mat.ke):
            al_ref = w.emit(struct.pack("<i", TYPE_AREA_LIGHT)
                            + struct.pack("<3f", *mat.ke))
        payload = (struct.pack("<i", TYPE_TRIANGLE_MESH)
                   + struct.pack("<i", int(mat_ids_pbf[mi - 1])
                                 if mi >= 1 else -1)
                   + struct.pack("<i", al_ref)
                   + _pack_vec(v.astype(np.float32))
                   + _pack_vec(n.astype(np.float32))
                   + _pack_vec(uv.astype(np.float32))
                   + _pack_vec(idx))
        shape_ids.append(w.emit(payload))

    obj = [struct.pack("<i", TYPE_OBJECT), _pack_str("world"),
           struct.pack("<i", len(shape_ids))]
    obj += [struct.pack("<i", s) for s in shape_ids]
    obj.append(struct.pack("<i", 0))          # no nested instances
    world = w.emit(b"".join(obj))
    w.emit(struct.pack("<ii", TYPE_SCENE, world))
    w.save(path)


def load_pbf(path: str):
    """Read a .pbf container. Returns the loader contract of load_pbrt:
    (v0,v1,v2,n0,n1,n2,uv0,uv1,uv2, mat_id, materials, area_light_hint).
    Instances are applied single-level (the reference calls
    makeSingleLevel before upload, src/scene.cpp:580)."""
    r = _Reader(path)
    scene = None
    for e in reversed(r.entities):
        if isinstance(e, dict) and e.get("tag") == TYPE_SCENE:
            scene = e
            break
    if scene is None:
        raise ValueError(f"{path}: no Scene entity found")

    def entity(i):
        if i < 0 or i >= len(r.entities):
            return None
        return r.entities[i]

    materials: list[MtlMaterial] = []
    mat_index: dict[int, int] = {}      # entity ID -> materials index

    def material_for(eid: int, al_eid: int) -> int:
        key = (eid, al_eid)
        if key in mat_index:
            return mat_index[key]
        ent = entity(eid)
        if ent is None or ent.get("tag") != TYPE_MATERIAL:
            m = MtlMaterial(name="default")
        else:
            m = _pbf_to_mtl(ent["kind"], ent["params"])
        al = entity(al_eid)
        if al is not None and al.get("tag") == TYPE_AREA_LIGHT:
            from fluctus_tpu_torch.core.types import BXDF_EMISSIVE
            import dataclasses
            m = dataclasses.replace(
                m, ke=tuple(float(x) for x in al["L"]),
                bsdf_type=BXDF_EMISSIVE)
        materials.append(m)
        mat_index[key] = len(materials) - 1
        return mat_index[key]

    tv, tn, tuv, tmat = [], [], [], []

    def emit_object(oid: int, xfm: np.ndarray):
        ent = entity(oid)
        if ent is None or ent.get("tag") != TYPE_OBJECT:
            return
        lin, off = xfm[:3, :3], xfm[:3, 3]
        it = np.linalg.inv(lin).T if abs(np.linalg.det(lin)) > 1e-30 \
            else np.eye(3)
        for sid in ent["shapes"]:
            sh = entity(sid)
            if sh is None or sh.get("tag") != TYPE_TRIANGLE_MESH:
                continue
            mi = material_for(sh["material"], sh["area_light"])
            v = sh["vertex"] @ lin.T + off
            n = sh["normal"] @ it.T if len(sh["normal"]) else sh["normal"]
            uv = sh["texcoord"]
            for f in sh["index"]:
                p3 = v[f]
                if len(n):
                    n3 = n[f]
                else:
                    fn = np.cross(p3[1] - p3[0], p3[2] - p3[0])
                    ln = np.linalg.norm(fn)
                    n3 = np.stack([fn / ln if ln > 0 else fn] * 3)
                tv.append(p3)
                tn.append(n3)
                tuv.append(uv[f] if len(uv) else np.zeros((3, 2)))
                tmat.append(mi + 1)      # 0 = default material slot
        for iid in ent.get("instances", ()):
            inst = entity(iid)
            if inst is None or inst.get("tag") != TYPE_INSTANCE:
                continue
            child = np.eye(4)
            child[:3, :3] = inst["xfm"][:3, :3]
            child[:3, 3] = inst["xfm"][:3, 3]
            emit_object(inst["object"], xfm @ child)

    emit_object(scene["world"], np.eye(4))
    if not tv:
        raise ValueError(f"{path}: no triangle geometry found")

    # area-light hint: first emissive quad (two coplanar tris sharing a
    # diagonal would need welding; use the first emissive mesh's bbox
    # frame like the pbrt text path's quad capture when it IS a quad)
    area_light = _quad_hint(tv, tmat, materials)

    v = np.asarray(tv, np.float32)
    n = np.asarray(tn, np.float32)
    uv = np.asarray(tuv, np.float32)
    return (v[:, 0], v[:, 1], v[:, 2], n[:, 0], n[:, 1], n[:, 2],
            uv[:, 0], uv[:, 1], uv[:, 2],
            np.asarray(tmat, np.int32), materials, area_light)


def _quad_hint(tv, tmat, materials):
    from fluctus_tpu_torch.core.types import BXDF_EMISSIVE
    em = [i for i, m in enumerate(materials)
          if m.bsdf_type == BXDF_EMISSIVE]
    if not em:
        return None
    mi = em[0] + 1
    tris = [np.asarray(t) for t, m in zip(tv, tmat) if m == mi]
    if len(tris) != 2:
        return None
    pts = np.unique(np.concatenate(tris).round(6), axis=0)
    if len(pts) != 4:
        return None
    c = pts.mean(axis=0)
    # order the 4 corners around the centroid to recover the frame
    d = pts - c
    ref = d[0] / np.linalg.norm(d[0])
    nrm = np.cross(d[0], d[1])
    if np.linalg.norm(nrm) <= 0:
        return None
    nrm = nrm / np.linalg.norm(nrm)
    ang = np.arctan2(d @ np.cross(nrm, ref), d @ ref)
    p = pts[np.argsort(ang)]
    e0, e1 = p[1] - p[0], p[3] - p[0]
    # orient the reconstructed frame to the stored triangle winding (the
    # sorted-corner order is arbitrary and can flip the emitter)
    t0 = tris[0]
    tri_n = np.cross(t0[1] - t0[0], t0[2] - t0[0])
    if np.dot(np.cross(e0, e1), tri_n) < 0:
        e0, e1 = e1, e0
    return {
        "pos": c, "right": e0 / np.linalg.norm(e0),
        "up": e1 / np.linalg.norm(e1),
        "normal": np.cross(e0, e1) / np.linalg.norm(np.cross(e0, e1)),
        "size": np.array([np.linalg.norm(e0) * 0.5,
                          np.linalg.norm(e1) * 0.5]),
        "emission": np.asarray(materials[em[0]].ke, np.float64),
    }


def convert_pbrt_to_pbf(src: str, dst: str):
    """.pbrt text -> .pbf binary (reference: Scene::convertPBRTModel,
    src/scene.cpp:567-571)."""
    from fluctus_tpu_torch.scene.loaders.pbrt import load_pbrt
    res = load_pbrt(src, cache_dir=None)
    write_pbf(dst, *res[:10], res[10], res[11])
