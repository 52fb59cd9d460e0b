"""Scene, parameter and hit records as dataclasses of torch tensors.

Counterpart of `fluctus_tpu/core/types.py`. The JAX package keeps these as
flax pytrees split into jit-static and traced fields; PyTorch runs eagerly,
so every record here is a plain dataclass and `RenderConfig` is a frozen
dataclass of Python values. Field names, shapes and dtypes follow the JAX
records so tests can compare the two field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# BSDF taxonomy: bitmask values of the reference's scene files
# (reference: src/bxdf_types.h:4-11).
BXDF_DIFFUSE = 1 << 1
BXDF_GLOSSY = 1 << 2
BXDF_GGX_ROUGH_REFLECTION = 1 << 3
BXDF_IDEAL_REFLECTION = 1 << 4
BXDF_GGX_ROUGH_DIELECTRIC = 1 << 5
BXDF_IDEAL_DIELECTRIC = 1 << 6
BXDF_EMISSIVE = 1 << 7
BXDF_SINGULAR_MASK = BXDF_IDEAL_REFLECTION | BXDF_IDEAL_DIELECTRIC

BSDF_TYPES = [
    BXDF_DIFFUSE, BXDF_GLOSSY, BXDF_GGX_ROUGH_REFLECTION,
    BXDF_IDEAL_REFLECTION, BXDF_GGX_ROUGH_DIELECTRIC, BXDF_IDEAL_DIELECTRIC,
    BXDF_EMISSIVE,
]
BSDF_ID = {t: i for i, t in enumerate(BSDF_TYPES)}
NUM_BSDF_TYPES = len(BSDF_TYPES)


@dataclass
class Materials:
    """SoA material table (reference: src/geom.h:113-124)."""
    kd: torch.Tensor       # (M, 3) f32
    ks: torch.Tensor       # (M, 3) f32
    ke: torch.Tensor       # (M, 3) f32
    ns: torch.Tensor       # (M,) f32
    ni: torch.Tensor       # (M,) f32
    map_kd: torch.Tensor   # (M,) i64 texture index or -1
    map_ks: torch.Tensor   # (M,) i64
    map_n: torch.Tensor    # (M,) i64 normal map
    bsdf_id: torch.Tensor  # (M,) i64 dense id into BSDF_TYPES


@dataclass
class TextureAtlas:
    """All textures in one flat RGBA8 byte buffer plus descriptors
    (reference: src/clcontext.cpp:570-611)."""
    data: torch.Tensor     # (total_bytes,) uint8
    offset: torch.Tensor   # (T,) i64 byte offset
    width: torch.Tensor    # (T,) i64
    height: torch.Tensor   # (T,) i64

    @property
    def empty(self) -> bool:
        # the 1-byte placeholder of TexturePool.pack; a real texture is >= 4
        return self.data.shape[0] < 4


@dataclass
class WideBVH:
    """8-wide fat-leaf hierarchy rows (accel/wide.py layout)."""
    nodes: torch.Tensor    # (N, 56) f32: 8 x [lo(3) hi(3)] + 8 refs (i32 bits)
    leaves: torch.Tensor   # (L, W, 10) f32: [v0 e1 e2 id(i32 bits)]
    root_ref: int = 0
    depth: int = 8
    leaf_width: int = 16


@dataclass
class FlatBVH:
    """Flat binary hierarchy, left child = index + 1 (reference:
    src/geom.h:71-80 `GPUNode`), traced by the `backend="jnp"` walk of
    ops/traverse.py."""
    node_lo: torch.Tensor     # (N, 3) f32
    node_hi: torch.Tensor     # (N, 3) f32
    node_right: torch.Tensor  # (N,) i32: inner -> right child; leaf -> start
    node_count: torch.Tensor  # (N,) i32: 0 inner, prim count for a leaf
    node_parent: torch.Tensor  # (N,) i32, -1 at the root
    prim_idx: torch.Tensor    # (K,) i32 triangle ids


@dataclass
class PackedBVH:
    """Child-pair rows and swizzled leaves (accel/pack.py layout), traced
    by the `backend="packed"` walk of ops/traverse_packed.py."""
    child_boxes: torch.Tensor  # (N, 16) f32
    child_refs: torch.Tensor   # (N, 2) i32: >= 0 inner, ~leaf row
    leaf_tris: torch.Tensor    # (L, 8, 9) f32 [v0 e1 e2]
    leaf_ids: torch.Tensor     # (L, 8) i32, -1 in pad slots
    root_ref: int = 0


@dataclass
class BruteForest:
    """Brute-chunk tables of a big scene (accel/forest.py layout): spatial
    bins of triangles with no hierarchy inside a bin. Traversed by
    ops/traverse_brute.py (kernels K2 and K3)."""
    tris: torch.Tensor      # (C, 16, Tp) f32: [ax ay az e1 e2 tid+1 0..]
    boxes: torch.Tensor     # (C, 8) f32 chunk AABB lo(3) hi(3) pad(2)
    boxes_t: torch.Tensor   # (8, Cp) f32 component-major chunk AABBs
    # (C, 8, NTp) f32 per-tile AABBs; None selects the round-loop scheduler
    tboxes: torch.Tensor | None = None
    tile: int = 512         # triangles per tboxes entry


@dataclass
class ForestTables:
    """Treelet-forest tables of a big scene (accel/forest.py
    `build_host_forest`): one 8-wide BVH per spatial chunk, each rooted at
    node 0 with global triangle ids, stacked and padded to one shape.
    Traversed by ops/traverse_forest.py (kernel K5). The JAX package
    re-encodes these rows in bf16 for its one-hot matmul gathers; the
    port keeps the f32 staging rows, which K5 reads per thread."""
    nodes: torch.Tensor     # (C, Tp, 56) f32 wide-node rows
    leaves: torch.Tensor    # (C, Lp, W, 10) f32 leaf rows
    boxes: torch.Tensor     # (C, 8) f32 chunk AABB lo(3) hi(3) pad(2)
    lvl: int = 1            # max wide depth over chunks + 1
    leaf_width: int = 16


@dataclass
class Geometry:
    """SoA triangle soup (reference: src/geom.h:89-95)."""
    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor   # (M,) i64


@dataclass
class AreaLight:
    """Rectangular area light (reference: src/geom.h:103-111)."""
    pos: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    normal: torch.Tensor
    emission: torch.Tensor
    size: torch.Tensor     # (2,) half extents


@dataclass
class Camera:
    """Pinhole + thin-lens camera (reference: src/geom.h:146-155)."""
    pos: torch.Tensor
    dir: torch.Tensor
    up: torch.Tensor
    right: torch.Tensor
    fov: torch.Tensor           # () degrees
    aperture_size: torch.Tensor
    focal_dist: torch.Tensor


@dataclass
class EnvMap:
    """Lat-long HDR environment with alias-method importance tables
    (reference: src/envmap.{hpp,cpp}, src/env_map.cl)."""
    image: torch.Tensor        # (H, W, 3) f32 linear radiance
    pdf_table: torch.Tensor    # (H*W,) f32 flat image-space pdf (mean 1)
    prob_table: torch.Tensor   # (H*W,) f32 alias acceptance probability
    alias_table: torch.Tensor  # (H*W,) int32 alias index


@dataclass
class DeviceScene:
    """Scene tensors on one device. A scene above the fast-big cutover
    carries `bforest` and no hierarchy (`wbvh` None); a scene uploaded
    with wide tables above 8 MB carries, beside `wbvh`, `ftables` under
    FLUCTUS_FOREST=treelet, or under FLUCTUS_PACKET_FOREST=1 the packet
    forest: `wforest`, one `WideBVH` a chunk (every chunk padded to the
    same rows, its root inner), and `wforest_maps`, each chunk's int32 map
    from its triangle ids to global ids. `envmap` is always present: the loaded env
    map, or a 1x1 black one when none is loaded (the JAX package's
    `envmap.dummy()`), which `RenderConfig.use_env_map` then leaves
    unread. `bvh` and `pbvh`, the tables of the XLA backends "jnp" and
    "packed", are uploaded only for a session that names that backend."""
    geom: Geometry
    wbvh: WideBVH | None
    materials: Materials
    atlas: TextureAtlas
    envmap: EnvMap
    bforest: BruteForest | None = None
    ftables: ForestTables | None = None
    bvh: FlatBVH | None = None
    pbvh: PackedBVH | None = None
    wforest: tuple = ()
    wforest_maps: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.geom.v0.device


@dataclass
class RenderParams:
    """Per-frame parameters (reference: src/geom.h:163-180)."""
    camera: Camera
    area_light: AreaLight
    env_strength: torch.Tensor
    world_radius: torch.Tensor
    exposure: torch.Tensor


@dataclass(frozen=True)
class RenderConfig:
    """Static configuration, the reference's compile defines
    (src/kernel_impl.hpp:49-67). The traversal runs the kernels on a CUDA
    scene and their plain versions on a CPU scene. `backend` selects it:

    - "auto" or "mxu": the per-lane kernels, K1 over the 8-wide BVH, K2/K3
      on a scene with a brute forest, K5 on one with a treelet forest.
      The JAX package resolves "auto" to "wide" on its CPU; the port's
      plain K1 is that same restart-trail walk, so one name serves both.
    - "pallas": the packet kernel K4 over the 8-wide BVH (a forest scene
      still takes the per-lane kernels, as in the JAX package).
    - "jnp", "packed", "wide": the JAX package's XLA walks as plain
      PyTorch on the session's device (ops/traverse.py over `bvh`,
      ops/traverse_packed.py over `pbvh`, ops/traverse_wide.py over
      `wbvh`): no kernel, taken only when named.
    """
    width: int = 512
    height: int = 512
    max_bounces: int = 4
    use_env_map: bool = True
    use_area_light: bool = False
    sample_impl: bool = True
    sample_expl: bool = True
    use_roulette: bool = False
    tonemap_op: int = 2
    bsdf_types_mask: int = 0xFE
    tile_size: int = 1 << 16
    backend: str = "auto"
    # paths in flight in the wavefront integrators (reference wfBufferSize
    # default 2^20, src/settings.cpp:20)
    pool_size: int = 1 << 20

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class Hit:
    """Batched hit record (reference: src/geom.h:133-142)."""
    t: torch.Tensor
    prim: torch.Tensor      # i64, -1 = miss
    p: torch.Tensor
    n: torch.Tensor
    uv: torch.Tensor
    mat_id: torch.Tensor
    area_light: torch.Tensor  # bool


def empty_hit(shape, t_max: float = 3.4028234663852886e38,
              device="cpu") -> Hit:
    """A miss everywhere (the reference's EMPTY_HIT, src/geom.h:144): t at
    t_max (float32's largest by default), prim -1, zero point, normal, uv
    and material, no area-light hit. Ids are int64, as the port's hits
    carry them."""
    shape = tuple(shape)
    z3 = torch.zeros(shape + (3,), dtype=torch.float32, device=device)
    return Hit(
        t=torch.full(shape, t_max, dtype=torch.float32, device=device),
        prim=torch.full(shape, -1, dtype=torch.int64, device=device),
        p=z3, n=z3.clone(),
        uv=torch.zeros(shape + (2,), dtype=torch.float32, device=device),
        mat_id=torch.zeros(shape, dtype=torch.int64, device=device),
        area_light=torch.zeros(shape, dtype=torch.bool, device=device))


@dataclass
class PathState:
    """Per-path wavefront state over the path pool (reference:
    src/geom.h:196-236 `GPUTaskState`). The JAX package keeps the counters
    as uint32; here they are int64 tensors holding the same values."""
    orig: torch.Tensor           # (N, 3) f32
    dir: torch.Tensor            # (N, 3) f32
    throughput: torch.Tensor     # (N, 3) f32
    radiance: torch.Tensor       # (N, 3) f32
    pixel_index: torch.Tensor    # (N,) i64
    sample_index: torch.Tensor   # (N,) i64, the per-pixel sample counter
    path_len: torch.Tensor       # (N,) i64
    last_pdf_w: torch.Tensor     # (N,) f32
    last_specular: torch.Tensor  # (N,) bool
    alive: torch.Tensor          # (N,) bool


def _vec(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def default_camera(device="cuda") -> Camera:
    """reference: src/tracer.cpp:760-776."""
    return Camera(pos=_vec([0.0, 1.0, 3.5], device),
                  dir=_vec([0.0, 0.0, -1.0], device),
                  up=_vec([0.0, 1.0, 0.0], device),
                  right=_vec([1.0, 0.0, 0.0], device),
                  fov=_vec(60.0, device), aperture_size=_vec(0.0, device),
                  focal_dist=_vec(0.5, device))


def default_area_light(device="cuda") -> AreaLight:
    """reference: src/tracer.cpp:789-798."""
    return AreaLight(pos=_vec([1.0, 1.0, 0.0], device),
                     right=_vec([0.0, 0.0, -1.0], device),
                     up=_vec([0.0, 1.0, 0.0], device),
                     normal=_vec([-1.0, 0.0, 0.0], device),
                     emission=_vec([200.0, 200.0, 200.0], device),
                     size=_vec([0.5, 0.5], device))


def default_params(world_radius: float = 1.0, device="cuda") -> RenderParams:
    return RenderParams(camera=default_camera(device),
                        area_light=default_area_light(device),
                        env_strength=_vec(1.0, device),
                        world_radius=_vec(world_radius, device),
                        exposure=_vec(1.0, device))
