"""Host scene: loader -> flat NumPy arrays -> hierarchy -> DeviceScene
(counterpart of `fluctus_tpu/scene/scene.py`; reference: src/scene.cpp,
src/tracer.cpp:574-590).

Input by extension: OBJ/MTL, PLY, PBRT text (with its parse cache) and the
PBF binary container, plus an optional Radiance HDR env map. The hierarchy
comes from the native SAH/SBVH builder, or the NumPy builders under
FLUCTUS_NATIVE=0, through an npz cache keyed by builder version and scene
hash that the two packages share. Then one of two uploads: the 8-wide
collapse and upload of its f32 rows (with a treelet forest beside them
under FLUCTUS_FOREST=treelet, or the packet forest under
FLUCTUS_PACKET_FOREST=1, see `HostScene.to_device`); or, for a scene
above the fast-big cutover on a CUDA device, the brute-chunk forest alone
(`fast_big_eligible`).
"""
from __future__ import annotations

import os
import zipfile
from dataclasses import dataclass, field

import numpy as np
import torch

from fluctus_tpu_torch.accel import bvh as bvh_mod
from fluctus_tpu_torch.accel.forest import (
    TARGET_TRIS, build_binary, build_brute_forest, build_host_forest,
    native_enabled)
from fluctus_tpu_torch.accel.pack import pack_bvh
from fluctus_tpu_torch.accel.wide import (
    LEAF_WIDTH, build_wide, build_wide_forest)
from fluctus_tpu_torch.core.types import (
    BSDF_ID, BXDF_DIFFUSE, BruteForest, DeviceScene, EnvMap, FlatBVH,
    ForestTables, Geometry, Materials, PackedBVH, TextureAtlas, WideBVH)
from fluctus_tpu_torch.scene import envmap as envmap_mod
from fluctus_tpu_torch.scene.envmap import HostEnvMap
from fluctus_tpu_torch.scene.loaders.obj import MtlMaterial, load_obj
from fluctus_tpu_torch.scene.loaders.ply import load_ply
from fluctus_tpu_torch.scene.textures import TexturePool
from fluctus_tpu_torch.scene.xxh64 import file_hash

__all__ = ["HostScene", "load_scene", "file_hash", "default_material",
           "fast_big_eligible", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = "data/hierarchies"

# wide tables above this many bytes take a forest in the JAX package
# (its TPU kernels keep the tables in VMEM); the port follows its rule
FOREST_TABLE_BYTES = 8 << 20
# the packet forest's budget of estimated table bytes per chunk (the
# default of the JAX package's build_wide_forest)
FOREST_CHUNK_BYTES = 4 << 20


def default_material() -> MtlMaterial:
    """reference: src/scene.cpp:13-26 (Kd 0.64, Ni 1.8, Ns 700, diffuse)."""
    return MtlMaterial(name="__default__", kd=(0.64, 0.64, 0.64),
                       ks=(0.0, 0.0, 0.0), ke=(0.0, 0.0, 0.0),
                       ns=700.0, ni=1.8, bsdf_type=BXDF_DIFFUSE)


@dataclass
class HostScene:
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    uv2: np.ndarray
    mat_id: np.ndarray
    materials: list                       # [0] = default material
    textures: TexturePool = field(default_factory=TexturePool)
    bvh: bvh_mod.BuiltBVH | None = None
    hash: str = ""
    name: str = ""
    map_kd: np.ndarray | None = None
    map_ks: np.ndarray | None = None
    map_n: np.ndarray | None = None
    envmap: HostEnvMap | None = None
    # quad-emitter frame from a PBRT AreaLightSource (loaders/pbrt.py) or a
    # PBF emissive quad: pos/right/up/normal/size/emission
    area_light_hint: dict | None = None

    @property
    def n_tris(self) -> int:
        return len(self.v0)

    @property
    def material_types_mask(self) -> int:
        """BSDF types present (reference: src/scene.cpp:299)."""
        mask = 0
        for m in self.materials:
            mask |= m.bsdf_type
        return mask

    def bounds(self):
        lo = np.minimum(np.minimum(self.v0.min(0), self.v1.min(0)),
                        self.v2.min(0))
        hi = np.maximum(np.maximum(self.v0.max(0), self.v1.max(0)),
                        self.v2.max(0))
        return lo, hi

    def world_radius(self) -> float:
        """Half the scene diagonal (reference: src/tracer.cpp:66-67)."""
        lo, hi = self.bounds()
        return float(np.linalg.norm(hi - lo) * 0.5)

    def load_env_map(self, path: str) -> None:
        """Read a Radiance .hdr and build its sampling tables."""
        self.envmap = envmap_mod.load(path)

    def build_bvh(self, cache_dir: str | None = DEFAULT_CACHE_DIR,
                  use_sbvh: bool = True) -> None:
        """Load the cached hierarchy, or build it and cache it (reference:
        src/tracer.cpp:574-590 initHierarchy). The cache is the JAX
        package's: `hierarchy_{sbvh|bvh}_v{BUILDER_VERSION}_{hash}.npz`
        in `cache_dir` with the same keys, so either package reads what
        the other wrote. The native builder builds unless FLUCTUS_NATIVE=0
        selects the NumPy SBVH or SAH builder; a failed native build
        raises (the JAX package gives way to NumPy there). A cache file
        that cannot be read (one the JAX package is still writing in
        place, say) is built and written again."""
        cache_path = None
        if cache_dir and self.hash:
            kind = "sbvh" if use_sbvh else "bvh"
            cache_path = os.path.join(
                cache_dir, f"hierarchy_{kind}_v{bvh_mod.BUILDER_VERSION}_"
                f"{self.hash}.npz")
            if os.path.exists(cache_path):
                try:
                    with np.load(cache_path) as z:
                        self.bvh = bvh_mod.BuiltBVH(
                            node_lo=z["node_lo"], node_hi=z["node_hi"],
                            node_right=z["node_right"],
                            node_count=z["node_count"],
                            node_parent=z["node_parent"],
                            prim_idx=z["prim_idx"], depth=int(z["depth"]))
                    return
                except (OSError, ValueError, KeyError, zipfile.BadZipFile):
                    pass    # unreadable (the JAX package writes in place)
        if not native_enabled():
            if use_sbvh:
                from fluctus_tpu_torch.accel.sbvh import build_sbvh
                self.bvh = build_sbvh(self.v0, self.v1, self.v2)
            else:
                self.bvh = bvh_mod.build_bvh(self.v0, self.v1, self.v2)
        else:
            from fluctus_tpu_torch.accel import native
            self.bvh = native.build_native(
                self.v0, self.v1, self.v2, bvh_mod.MAX_LEAF,
                bvh_mod.MAX_DEPTH, 1e-5, use_sbvh)
        if cache_path:
            os.makedirs(cache_dir, exist_ok=True)
            # a temporary name in the same directory, then one rename:
            # concurrent sessions never read a half-written file
            tmp = f"{cache_path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.savez_compressed(
                    f, node_lo=self.bvh.node_lo, node_hi=self.bvh.node_hi,
                    node_right=self.bvh.node_right,
                    node_count=self.bvh.node_count,
                    node_parent=self.bvh.node_parent,
                    prim_idx=self.bvh.prim_idx, depth=self.bvh.depth)
            os.replace(tmp, cache_path)

    def material_arrays(self):
        mats = self.materials
        n = len(mats)
        none = np.full(n, -1, np.int64)
        return dict(
            kd=np.asarray([m.kd for m in mats], np.float32),
            ks=np.asarray([m.ks for m in mats], np.float32),
            ke=np.asarray([m.ke for m in mats], np.float32),
            ns=np.asarray([m.ns for m in mats], np.float32),
            ni=np.asarray([m.ni for m in mats], np.float32),
            map_kd=none if self.map_kd is None else self.map_kd,
            map_ks=none if self.map_ks is None else self.map_ks,
            map_n=none if self.map_n is None else self.map_n,
            bsdf_id=np.asarray([BSDF_ID[m.bsdf_type] for m in mats],
                               np.int64))

    def to_device(self, device="cuda", backend: str = "auto") -> DeviceScene:
        """Upload geometry, the traversal tables, materials, the texture
        atlas and the env map with its tables, or the 1x1 black map when
        none is loaded (reference: CLContext::uploadSceneData,
        src/clcontext.cpp:522-611, createEnvMap :467-519).

        Tables: above the fast-big cutover, the brute-chunk forest alone
        (no hierarchy). Otherwise the 8-wide BVH; when its tables pass
        FOREST_TABLE_BYTES (8 MB), the forest knobs decide what goes
        beside it:

        - FLUCTUS_PACKET_FOREST=1: the packet forest (`wforest`,
          `wforest_maps`), one 8-wide BVH per chunk of at most
          FOREST_CHUNK_BYTES of estimated tables, traced chunk by chunk
          by K1 (or K4 under backend "pallas");
        - FLUCTUS_FOREST=treelet: the treelet forest (`ftables`, traced by
          K5), sized by FLUCTUS_FOREST_TARGET_TRIS and
          FLUCTUS_FOREST_LEAF_WIDTH;
        - otherwise nothing: the hierarchy alone, traced by K1. The JAX
          package builds a brute forest here and traces through it; on
          the card K1 over the full hierarchy is much faster than K2 on
          the same rays, and both return the same hits up to equal-t
          ties, so the port keeps K1 (ROADMAP Queue 3).

        `backend` "jnp" also uploads the binary hierarchy (`bvh`) and
        "packed" its packed rows (`pbvh`, accel/pack.py) for those walks;
        every other backend uploads neither (the JAX package uploads
        both always).
        """
        dev = torch.device(device)

        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        geom = Geometry(v0=t(self.v0), v1=t(self.v1), v2=t(self.v2),
                        n0=t(self.n0), n1=t(self.n1), n2=t(self.n2),
                        uv0=t(self.uv0), uv1=t(self.uv1), uv2=t(self.uv2),
                        mat_id=t(self.mat_id, torch.int64))
        wbvh = bforest = ftables = bvh = pbvh = None
        wforest, wforest_maps = (), ()
        if fast_big_eligible(self, dev):
            target = int(os.environ.get("FLUCTUS_BRUTE_TARGET_TRIS",
                                        _brute_auto_target(self.n_tris)))
            hb = build_brute_forest(self.v0, self.v1, self.v2,
                                    target_tris=target)
            bforest = BruteForest(tris=t(hb.tris), boxes=t(hb.boxes),
                                  boxes_t=t(hb.boxes_t),
                                  tboxes=t(hb.tboxes), tile=hb.tile)
        else:
            if self.bvh is None:
                self.build_bvh(cache_dir=None, use_sbvh=False)
            wide = build_wide(self.bvh, self.v0, self.v1, self.v2)
            wbvh = WideBVH(nodes=t(wide.nodes), leaves=t(wide.leaves),
                           root_ref=int(wide.root_ref),
                           depth=int(wide.depth),
                           leaf_width=int(wide.leaves.shape[1]))
            if backend == "jnp":
                bvh = FlatBVH(*(t(getattr(self.bvh, f)) for f in (
                    "node_lo", "node_hi", "node_right", "node_count",
                    "node_parent", "prim_idx")))
            elif backend == "packed":
                pk = pack_bvh(self.bvh, self.v0, self.v1, self.v2)
                pbvh = PackedBVH(
                    child_boxes=t(pk.child_boxes),
                    child_refs=t(pk.child_refs), leaf_tris=t(pk.leaf_tris),
                    leaf_ids=t(pk.leaf_ids), root_ref=pk.root_ref)
            if (wide.nodes.size + wide.leaves.size) * 4 > FOREST_TABLE_BYTES:
                if os.environ.get("FLUCTUS_PACKET_FOREST", "0") == "1":
                    hosts, maps = build_wide_forest(
                        self.v0, self.v1, self.v2, build_binary,
                        budget_bytes=FOREST_CHUNK_BYTES)
                    wforest = pad_forest(hosts, t)
                    wforest_maps = tuple(t(m) for m in maps)
                elif _forest_knob() == "treelet":
                    hf = build_host_forest(
                        self.v0, self.v1, self.v2,
                        target_tris=int(os.environ.get(
                            "FLUCTUS_FOREST_TARGET_TRIS", TARGET_TRIS)),
                        leaf_width=int(os.environ.get(
                            "FLUCTUS_FOREST_LEAF_WIDTH", LEAF_WIDTH)))
                    ftables = ForestTables(
                        nodes=t(hf.nodes), leaves=t(hf.leaves),
                        boxes=t(hf.boxes), lvl=hf.lvl,
                        leaf_width=hf.leaf_width)
        m = self.material_arrays()
        mats = Materials(**{k: t(v, torch.int64 if v.dtype.kind == "i"
                                 else None) for k, v in m.items()})
        data, offs, ws, hs = self.textures.pack()
        atlas = TextureAtlas(data=t(data), offset=t(offs), width=t(ws),
                             height=t(hs))
        env = self.envmap if self.envmap is not None else envmap_mod.dummy()
        envd = EnvMap(image=t(env.image), pdf_table=t(env.pdf_table),
                      prob_table=t(env.prob_table),
                      alias_table=t(env.alias_table))
        return DeviceScene(geom=geom, wbvh=wbvh, materials=mats, atlas=atlas,
                           envmap=envd, bforest=bforest, ftables=ftables,
                           bvh=bvh, pbvh=pbvh, wforest=wforest,
                           wforest_maps=wforest_maps)


def pad_forest(hosts, t) -> tuple:
    """The packet forest's chunks (WideBVHHost) as WideBVH tables padded
    to the largest chunk's rows, put on the device by `t`: pad node rows
    are never hit (+inf at each child's lo.x), pad leaf slots hold the id
    -1 (the JAX package's `to_device` under FLUCTUS_PACKET_FOREST=1)."""
    n_max = max(h.nodes.shape[0] for h in hosts)
    l_max = max(h.leaves.shape[0] for h in hosts)
    chunks = []
    for h in hosts:
        assert h.root_ref == 0, "forest chunk root must be inner"
        nodes = np.zeros((n_max, 56), np.float32)
        nodes[:, 0:48:6] = np.inf
        nodes[:h.nodes.shape[0]] = h.nodes
        leaves = np.zeros((l_max,) + h.leaves.shape[1:], np.float32)
        leaves[..., 9] = np.int32(-1).view(np.float32)
        leaves[:h.leaves.shape[0]] = h.leaves
        chunks.append(WideBVH(nodes=t(nodes), leaves=t(leaves), root_ref=0,
                              depth=int(h.depth),
                              leaf_width=int(h.leaves.shape[1])))
    return tuple(chunks)


def _brute_auto_target(n_tris: int) -> int:
    """Chunk size scaled to the scene: a power of two between 8192 and
    32768 near n_tris / 192 (the JAX package's measured sweet spots)."""
    import math
    if n_tris <= 0:
        return 8192
    return 1 << int(np.clip(round(math.log2(max(n_tris / 192, 1))),
                            13, 15))


def _forest_knob() -> str:
    """FLUCTUS_FOREST: "brute" (the default) or "treelet"."""
    knob = os.environ.get("FLUCTUS_FOREST", "brute")
    if knob not in ("brute", "treelet"):
        raise ValueError(f"FLUCTUS_FOREST={knob!r}: use brute or treelet")
    return knob


def fast_big_eligible(host, device) -> bool:
    """True when `host` uploads to `device` as a brute-chunk forest alone:
    a CUDA device and more triangles than the cutover, (8 << 20) // 68 =
    123,361 by default (the JAX package's rule, whose platform test is an
    accelerator backend; on the CPU both build the full hierarchy).
    FLUCTUS_FAST_BIG_MIN_TRIS moves the cutover; FLUCTUS_FAST_BIG=0,
    FLUCTUS_FOREST=treelet and FLUCTUS_PACKET_FOREST=1 turn the path off,
    as in the JAX package (the latter two ask for another forest beside
    the full hierarchy, see `HostScene.to_device`)."""
    min_tris = int(os.environ.get("FLUCTUS_FAST_BIG_MIN_TRIS",
                                  (8 << 20) // 68))
    return (len(host.v0) > min_tris
            and torch.device(device).type == "cuda"
            and _forest_knob() == "brute"
            and os.environ.get("FLUCTUS_PACKET_FOREST", "0") != "1"
            and os.environ.get("FLUCTUS_FAST_BIG", "1") != "0")


def load_scene(path: str, env_map: str | None = None) -> HostScene:
    """Load a model by extension, .obj, .ply, .pbrt or .pbf, and with
    `env_map` a Radiance .hdr env map (reference: src/scene.cpp:53-103).
    A PBRT file is parsed through its cache in data/pbf_cache, as in the
    JAX package; PBRT and PBF scenes carry no normal maps (`map_n` stays
    -1) and may carry an area-light hint."""
    ext = os.path.splitext(path)[1].lower()
    pool = TexturePool()
    area_light_hint = None
    maps = None
    if ext == ".ply":
        v0, v1, v2, n0, n1, n2, uv0, uv1, uv2 = load_ply(path)
        mats = [default_material()]
        mat_id = np.zeros(len(v0), np.int32)
    elif ext == ".obj":
        mesh = load_obj(path)
        v0, v1, v2 = mesh.v0, mesh.v1, mesh.v2
        n0, n1, n2 = mesh.n0, mesh.n1, mesh.n2
        uv0, uv1, uv2 = mesh.uv0, mesh.uv1, mesh.uv2
        mat_id = mesh.mat_id
        mats = [default_material()] + mesh.materials
        maps = _import_maps(pool, mats, os.path.dirname(path),
                            ("map_kd", "map_ks", "map_bump"))
    elif ext in (".pbrt", ".pbf"):
        if ext == ".pbf":
            # the binary container, opened directly (reference:
            # src/scene.cpp:573-620 Scene::loadPBFModel)
            from fluctus_tpu_torch.scene.loaders.pbf import load_pbf
            (v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat_id,
             pbrt_mats, area_light_hint) = load_pbf(path)
        else:
            from fluctus_tpu_torch.scene.loaders.pbrt import load_pbrt
            (v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat_id,
             pbrt_mats, area_light_hint) = load_pbrt(path)
        mats = [default_material()] + pbrt_mats
        maps = _import_maps(pool, mats, os.path.dirname(path),
                            ("map_kd", "map_ks"))
    else:
        raise ValueError(f"unsupported scene format: {path} (use .obj, "
                         ".ply, .pbrt or .pbf)")
    scene = HostScene(
        v0=v0, v1=v1, v2=v2, n0=n0, n1=n1, n2=n2, uv0=uv0, uv1=uv1,
        uv2=uv2, mat_id=np.asarray(mat_id, np.int32), materials=mats,
        textures=pool, hash=file_hash(path), name=os.path.basename(path),
        area_light_hint=area_light_hint)
    if maps is not None:
        scene.map_kd = maps["map_kd"]
        scene.map_ks = maps["map_ks"]
        scene.map_n = maps.get("map_bump", np.full(len(mats), -1, np.int64))
    if env_map:
        scene.load_env_map(env_map)
    return scene


def _import_maps(pool: TexturePool, mats: list, folder: str,
                 keys: tuple) -> dict:
    """Texture slots of every material but the default one: {key: (M,)
    slot ids, -1 where a material names no map or its file is missing or
    damaged}."""
    maps = {k: np.full(len(mats), -1, np.int64) for k in keys}
    for i, mat in enumerate(mats[1:], start=1):
        for k in keys:
            name = getattr(mat, k)
            if name:
                maps[k][i] = pool.try_import(os.path.join(folder, name), name)
    return maps
