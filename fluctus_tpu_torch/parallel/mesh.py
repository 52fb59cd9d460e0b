"""Data parallelism over the ray/pixel axis, and the scene-parameter
losses and gradient steps (counterpart of `fluctus_tpu/parallel/mesh.py`).

A mesh is an ordered list of shards along one axis, RAY_AXIS. Inside one
process it holds one or more local devices, which may repeat (eight
"cpu" shards in the tests, four shards on one card); once
`torch.distributed` is initialised (`parallel/distributed.py`) it spans
the ranks, shard d = rank x local + i, and every rank holds the same
number of local shards. The scene is replicated: each rank builds its own
session and `place` copies it to each local device, as the JAX package's
multi-process `place` trusts each host's copy. Pixels and rays are split
into one contiguous stripe per shard; local shards run one after another.

The only traffic between ranks is the final image gather, the stream's
drain flag (MAX) and the all-reduce of losses and gradients (the psum
that GSPMD inserts in the JAX package). Under the gloo backend each of
those tensors is staged through the host (`_collective`); the renders
stay on their devices.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist

from fluctus_tpu_torch.core.types import DeviceScene, RenderParams
from fluctus_tpu_torch.integrators import lockstep, wavefront

RAY_AXIS = "rays"      # the one axis a mesh has (the JAX mesh's name)


@dataclass(frozen=True)
class Mesh:
    """This process's shards (`devices`, in shard order) and its place
    among the ranks: shard d = rank * local + i."""
    devices: tuple
    rank: int = 0
    world: int = 1

    @property
    def local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.local * self.world

    def shard(self, i: int) -> int:
        """The global index of local shard i."""
        return self.rank * self.local + i


def _ranked() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices` (this process's shards; default: every CUDA
    device, or under torch.distributed this rank's card), across all
    ranks once torch.distributed is initialised."""
    if devices is None:
        n = torch.cuda.device_count()
        if _ranked():
            devices = [torch.device("cuda", dist.get_rank() % max(n, 1))]
        else:
            devices = [torch.device("cuda", i) for i in range(max(n, 1))]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if not _ranked():
        return Mesh(devices)
    counts = _collective(torch.tensor([len(devices), -len(devices)],
                                      device=devices[0]),
                         dist.ReduceOp.MAX)
    if int(counts[0]) != -int(counts[1]):
        raise ValueError("every rank must hold the same number of shards")
    return Mesh(devices, dist.get_rank(), dist.get_world_size())


def _collective(x: torch.Tensor, op=None) -> torch.Tensor:
    """all_reduce of `x` under `op` (all_gather along dim 0 when op is
    None) across the ranks; `x` itself without ranks. NCCL reduces on
    the device; any other backend (gloo) gets a host copy, and the result
    goes back to x's device."""
    if not _ranked():
        return x
    staged = x if dist.get_backend() == "nccl" else x.cpu()
    staged = staged.contiguous()
    if op is None:
        parts = [torch.empty_like(staged)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, staged)
        staged = torch.cat(parts)
    else:
        dist.all_reduce(staged, op)
    return staged.to(x.device)


def _to(rec, dev):
    """A record of tensors (dataclasses, tuples) on `dev`."""
    if isinstance(rec, torch.Tensor):
        return rec.to(dev)
    if isinstance(rec, tuple):
        return tuple(_to(x, dev) for x in rec)
    if dataclasses.is_dataclass(rec) and not isinstance(rec, type):
        return dataclasses.replace(rec, **{
            f.name: _to(getattr(rec, f.name), dev)
            for f in dataclasses.fields(rec)})
    return rec


def place(scene: DeviceScene, params: RenderParams, mesh: Mesh) -> list:
    """[(scene, params)] on each local shard's device (the same tensors
    where a device repeats or already holds them)."""
    return [(_to(scene, d), _to(params, d)) for d in mesh.devices]


def stripe(n_items: int, mesh: Mesh, d: int) -> tuple:
    """(start, stop) of shard d's contiguous stripe of n_items padded to a
    multiple of the shard count."""
    n_loc = -(-n_items // mesh.size)
    return d * n_loc, (d + 1) * n_loc


def render_sharded(scene: DeviceScene, params: RenderParams, cfg, spp: int,
                   mesh: Mesh) -> torch.Tensor:
    """Exact-spp lockstep render with the pixels split over the shards:
    each shard sums lockstep.sample_radiance per sample over its stripe
    (in tiles of cfg.tile_size), the stripes are gathered across ranks
    and the pad pixels dropped. Returns the (H, W, 3) image on the first
    local device; every rank gets the whole image."""
    n_pix = cfg.width * cfg.height
    parts = []
    for i, (s_, p_) in enumerate(place(scene, params, mesh)):
        start, stop = stripe(n_pix, mesh, mesh.shard(i))
        dev = s_.device
        acc = torch.zeros((stop - start, 3), dtype=torch.float32, device=dev)
        for t0 in range(start, stop, cfg.tile_size):
            idx = torch.arange(t0, min(t0 + cfg.tile_size, stop),
                               dtype=torch.int32, device=dev)
            a = acc[t0 - start:t0 - start + idx.shape[0]]
            for s in range(spp):
                a = a + lockstep.sample_radiance(s_, p_, cfg, idx, s)
            acc[t0 - start:t0 - start + idx.shape[0]] = a
        parts.append(acc.to(mesh.devices[0]))
    img = _collective(torch.cat(parts))[:n_pix] / spp
    return img.reshape(cfg.height, cfg.width, 3)


def render_stream_sharded(scene: DeviceScene, params: RenderParams, cfg,
                          spp: int, mesh: Mesh,
                          segments_per_launch: int = 8):
    """The streaming wavefront with the pixels split over the shards: each
    shard streams its own stripe [d * n_loc, (d + 1) * n_loc) with its own
    pool of min(cfg.pool_size, n_loc * spp) lanes, respawn budget and
    binning; pad pixels past the frame render and are dropped. The drain
    test is read one launch late, as in the JAX package, and reduced with
    MAX across ranks. Equals `wavefront.render_stream` up to the order of
    each pixel's sum. Returns ((H, W, 3) image, per-shard counters
    [spawns, extension rays, shadow rays] (n_dev, 3) int64), both on the
    first local device and whole on every rank."""
    n_pix = cfg.width * cfg.height
    n_loc = -(-n_pix // mesh.size)
    total_loc = n_loc * spp
    pool = min(cfg.pool_size, total_loc)
    shards = []
    for i, (s_, p_) in enumerate(place(scene, params, mesh)):
        base = stripe(n_pix, mesh, mesh.shard(i))[0]
        state, counters = wavefront.init_stream_state(
            p_, cfg, pool, pix_base=base, n_pix_local=n_loc)
        shards.append({"scene": s_, "params": p_, "base": base,
                       "state": state, "counters": counters, "rows": []})

    cap = (total_loc // pool + cfg.max_bounces + 2) * 8 + 64
    it = 0
    pending = []      # lagged drain tests
    while it < cap:
        alive = []
        for sh in shards:
            sh["state"], sh["counters"], rows = wavefront.stream_rounds(
                sh["scene"], sh["params"], cfg, sh["state"], sh["counters"],
                spp, segments_per_launch, pix_base=sh["base"],
                n_pix_local=n_loc)
            sh["rows"].append(rows)
            alive.append(sh["state"].alive.any().to(mesh.devices[0]))
        it += segments_per_launch
        pending.append(torch.stack(alive).any().to(torch.int32))
        if len(pending) >= 2 and not bool(
                _collective(pending.pop(0), dist.ReduceOp.MAX)):
            break

    imgs, done = [], 0
    for sh in shards:
        r, g, b, pix = (torch.cat([c[k].reshape(-1) for c in sh["rows"]])
                        for k in range(4))
        pix = torch.where(pix >= 0, pix - sh["base"], -1)
        img, n_done = wavefront._bin_rows(
            wavefront.bucket_rows([r, g, b, pix], total_loc,
                                  pool * segments_per_launch), n_loc, spp)
        imgs.append(img.to(mesh.devices[0]))
        done = done + n_done.to(mesh.devices[0])
    done = int(_collective(done.reshape(1), dist.ReduceOp.SUM))
    n_pad = n_loc * mesh.size
    if done != n_pad * spp:
        raise RuntimeError(f"sharded stream drain incomplete: {done}/"
                           f"{n_pad * spp} samples (cap {cap})")
    img = _collective(torch.cat(imgs))[:n_pix]
    counters = _collective(torch.stack(
        [sh["counters"].to(mesh.devices[0]) for sh in shards]))
    return img.reshape(cfg.height, cfg.width, 3), counters


# camera leaves graftable by loss_fn: diff_params key "cam_<field>"
_CAM_FIELDS = ("pos", "dir", "up", "right", "fov", "aperture_size",
               "focal_dist")


def graft(diff_params: dict, scene: DeviceScene, params: RenderParams):
    """(scene, params) with the differentiable leaves of `diff_params` in
    place: any of kd, ks, ns, ni (materials), env_image, env_strength and
    the camera fields cam_pos, cam_dir, cam_up, cam_right, cam_fov,
    cam_aperture_size, cam_focal_dist (BASELINE config 5's parameter
    surface; reference: Camera inside RenderParams, src/geom.h:163-180).
    Gradients flow through the shading and camera math with visibility
    frozen (integrators/common.py)."""
    mats = dataclasses.replace(
        scene.materials, **{k: diff_params[k] for k in ("kd", "ks", "ns", "ni")
                            if k in diff_params})
    env = scene.envmap
    if "env_image" in diff_params:
        env = dataclasses.replace(env, image=diff_params["env_image"])
    scene = dataclasses.replace(scene, materials=mats, envmap=env)
    cam = dataclasses.replace(
        params.camera, **{f: diff_params[f"cam_{f}"] for f in _CAM_FIELDS
                          if f"cam_{f}" in diff_params})
    params = dataclasses.replace(params, camera=cam)
    if "env_strength" in diff_params:
        params = dataclasses.replace(params,
                                     env_strength=diff_params["env_strength"])
    return scene, params


def loss_fn(diff_params: dict, scene: DeviceScene, params: RenderParams,
            cfg, pixel_idx, sample_idx, target) -> torch.Tensor:
    """L2 image loss of one lockstep sample per listed pixel, with the
    leaves of `diff_params` grafted in (see graft)."""
    scene, params = graft(diff_params, scene, params)
    radiance = lockstep.sample_radiance(scene, params, cfg, pixel_idx,
                                        sample_idx)
    return torch.mean((radiance - target) ** 2)


def value_and_grad(fn, diff_params: dict, *args, has_aux: bool = False):
    """(fn's value, {key: gradient}) with respect to the leaves of
    `diff_params`, taken as fresh leaves (jax.value_and_grad's contract).
    With has_aux, fn returns (value, aux) and the value is (value, aux)."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in diff_params.items()}
    with torch.enable_grad():
        out = fn(leaves, *args)
        val = out[0] if has_aux else out
        grads = torch.autograd.grad(val, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(leaves, grads)}
    if has_aux:
        return (out[0].detach(), out[1]), grads
    return val.detach(), grads


def grad_step(diff_params: dict, scene: DeviceScene, params: RenderParams,
              cfg, pixel_idx, sample_idx, target, lr: float = 1e-2,
              mesh: Mesh | None = None):
    """One SGD step on the scene parameters; returns (loss, new
    diff_params). With `mesh`, each shard takes loss_fn on its stripe of
    the ray list (a multiple of the shard count long; every rank passes
    the whole list) and the losses and gradients are averaged over the
    shards: the mean over all rays, as GSPMD's psum gives in the JAX
    package."""
    if mesh is None:
        loss, grads = value_and_grad(loss_fn, diff_params, scene, params,
                                     cfg, pixel_idx, sample_idx, target)
    else:
        loss, grads, _ = _sharded(
            lambda d, s_, p_, pix, samp, tgt: (
                loss_fn(d, s_, p_, cfg, pix, samp, tgt), 0),
            diff_params, scene, params, pixel_idx, sample_idx, target, mesh)
    return loss, {k: (v.detach() - lr * grads[k].to(v.device))
                  for k, v in diff_params.items()}


def _sharded(fn, diff_params, scene, params, pixel_idx, sample_idx, target,
             mesh: Mesh):
    """fn(diff, scene, params, pixels, samples, target) -> (loss, count)
    on each shard's stripe of the ray list; returns the loss and the
    gradients averaged over the shards and the counts summed, on the
    first local device."""
    n = pixel_idx.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rays do not split into {mesh.size} equal "
                         "stripes")
    dev0 = mesh.devices[0]
    loss = count = 0
    grads = {}
    for i, (s_, p_) in enumerate(place(scene, params, mesh)):
        start, stop = stripe(n, mesh, mesh.shard(i))
        dev = s_.device
        samp = sample_idx
        if isinstance(samp, torch.Tensor) and samp.ndim:
            samp = samp[start:stop].to(dev)
        diff = {k: v.to(dev) for k, v in diff_params.items()}
        (l_, c_), g = value_and_grad(
            fn, diff, s_, p_, pixel_idx[start:stop].to(dev), samp,
            target[start:stop].to(dev), has_aux=True)
        loss = loss + l_.to(dev0)
        count = count + torch.as_tensor(c_, device=dev0)
        for k, x in g.items():
            grads[k] = grads.get(k, 0) + x.to(dev0)
    keys = list(grads)
    flat = torch.cat([loss.reshape(1)] + [grads[k].reshape(-1)
                                          for k in keys])
    flat = _collective(flat, dist.ReduceOp.SUM) / mesh.size
    count = _collective(count.reshape(1), dist.ReduceOp.SUM)[0]
    out, pos = {}, 1
    for k in keys:
        m = grads[k].numel()
        out[k] = flat[pos:pos + m].reshape(grads[k].shape)
        pos += m
    return flat[0], out, count


def grad_step_stream(diff_params: dict, scene: DeviceScene,
                     params: RenderParams, cfg, pixel_idx, sample_idx,
                     target, pool: int, n_segments: int, mesh: Mesh,
                     lr: float = 1e-2):
    """One SGD step through the streaming loss, split over the shards:
    each shard drains its own pool of `pool` lanes over its stripe of the
    ray list (loss_fn_stream, deferred), then the losses and gradients
    are averaged and the finished rays summed over the shards and ranks
    (the JAX package's pmean / psum). Returns (loss, new diff_params,
    n_done over all shards)."""
    loss, grads, n_done = _sharded(
        lambda d, s_, p_, pix, samp, tgt: loss_fn_stream(
            d, s_, p_, cfg, pix, samp, tgt, pool, n_segments,
            deferred=True),
        diff_params, scene, params, pixel_idx, sample_idx, target, mesh)
    return loss, {k: (v.detach() - lr * grads[k].to(v.device))
                  for k, v in diff_params.items()}, n_done


def loss_fn_stream(diff_params: dict, scene: DeviceScene,
                   params: RenderParams, cfg, pixel_idx, sample_idx,
                   target, pool: int, n_segments: int,
                   deferred: bool = False, weight=None):
    """L2 image loss through the differentiable streaming wavefront
    (wavefront.stream_loss, or stream_loss_deferred): the value of
    loss_fn (the same counter RNG) at the traced work of the paths'
    real lengths. With `weight`, the weighted-fold form. Returns (loss,
    n_done); n_done must equal len(pixel_idx) (size n_segments with
    wavefront.plan_stream_segments)."""
    scene, params = graft(diff_params, scene, params)
    fn = (wavefront.stream_loss_deferred if deferred
          else wavefront.stream_loss)
    return fn(scene, params, cfg, pixel_idx, sample_idx, target, pool,
              n_segments, weight=weight)
