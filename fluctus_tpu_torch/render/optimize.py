"""Inverse rendering: optimize scene parameters (materials, env emission,
camera) against a target image through pixel gradients (counterpart of
`fluctus_tpu/render/optimize.py`; BASELINE config 5).

Variance reduction, as in the JAX package:
  * paired-sample loss mean((I_A - t) * (I_B - t)) over two independent
    sample sets A and B: its expectation is the true squared error, and
    its gradient (I_A - t) dI_B + (I_B - t) dI_A is unbiased;
  * stratified pixel minibatches: `minibatch` pixels a step, one jittered
    pixel per stratum, drawn with the JAX package's PRNG
    (`core/jaxrand.py`), so both packages pick the same pixels;
  * an spp schedule: spp/4, then spp/2, then spp over the run.

Adam is `torch.optim.Adam` with optax's defaults (b1 0.9, b2 0.999, eps
1e-8). The checkpoint is the port's own file (the diff tensors, Adam's
state and the step, written atomically to `out_dir/ckpt/`); the port
reads no orbax directory.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from fluctus_tpu_torch.core import jaxrand
from fluctus_tpu_torch.integrators import lockstep, wavefront
from fluctus_tpu_torch.parallel.mesh import graft, loss_fn_stream

_DIFF_GETTERS = {
    "kd": lambda s, p: s.materials.kd,
    "ks": lambda s, p: s.materials.ks,
    "ns": lambda s, p: s.materials.ns,
    "ni": lambda s, p: s.materials.ni,
    "env_image": lambda s, p: s.envmap.image,
    "env_strength": lambda s, p: p.env_strength,
    "cam_pos": lambda s, p: p.camera.pos,
    "cam_dir": lambda s, p: p.camera.dir,
    "cam_fov": lambda s, p: p.camera.fov,
    "cam_aperture_size": lambda s, p: p.camera.aperture_size,
    "cam_focal_dist": lambda s, p: p.camera.focal_dist,
}
PIXEL_SEED = 0x0F17
CKPT_NAME = "state.pt"


def spp_schedule(steps: int, spp: int):
    """(n_steps, spp) phases ramping spp/4 -> spp/2 -> spp over the run."""
    if spp < 4:
        return [(steps, spp)]
    p1, p2 = int(steps * 0.4), int(steps * 0.3)
    return [(p1, max(1, spp // 4)), (p2, max(1, spp // 2)),
            (steps - p1 - p2, spp)]


def stratified_pixels(n_pix: int, mb: int, step: int, device):
    """The step's minibatch: one pixel per stratum of n_pix // mb pixels,
    jittered by randint under fold_in(PRNGKey(0x0F17), step), as the JAX
    package draws it; the first mb pixels when the strata are single."""
    stride = n_pix // mb
    base = torch.arange(mb, dtype=torch.int64)
    if stride > 1:
        key = jaxrand.fold_in(jaxrand.prng_key(PIXEL_SEED), step)
        base = base * stride + jaxrand.randint(key, mb, 0, stride)
    return base.to(device)


def resolve_method(method: str, device) -> str:
    """"auto" -> "stream" on a CUDA device, "lockstep" on the CPU (the JAX
    package picks by its backend)."""
    if method == "auto":
        return "stream" if torch.device(device).type == "cuda" else \
            "lockstep"
    if method not in ("stream", "lockstep"):
        raise ValueError(f"unknown method {method!r}")
    return method


def _no_lap(part: str) -> None:
    pass


def lockstep_grad(diff: dict, scene, params, cfg, pix, target, step: int,
                  cur_spp: int, on_lap=_no_lap):
    """The lockstep method's loss and gradients: the paired-sample loss of
    sets A (sample ids (2 step) cur_spp + k) and B ((2 step + 1) cur_spp +
    k) through the checkpointed lockstep. Returns (loss, {key: grad}).
    on_lap(part) is called after "forward" and "backward"."""
    tgt = target[pix]
    diff = {k: v.detach().requires_grad_(True) for k, v in diff.items()}
    with torch.enable_grad():
        s, p = graft(diff, scene, params)

        def render(s_idx):
            acc = 0.0
            for k in range(cur_spp):
                acc = acc + lockstep.sample_radiance(
                    s, p, cfg, pix, s_idx * cur_spp + k)
            return acc / cur_spp

        ia = render(step * 2)
        ib = render(step * 2 + 1)
        loss = torch.mean((ia - tgt) * (ib - tgt))
        on_lap("forward")
        grads = torch.autograd.grad(loss, list(diff.values()))
    on_lap("backward")
    return loss.detach(), dict(zip(diff, grads))


def plan_stream(scene, params, cfg, mb: int, cur_spp: int):
    """The stream step's (segments, pool): the pool n_total / 32 within
    [2^12, 2^15], the segments planned on step 0's pixels plus 15 % and 2
    (a jittered minibatch may drain later; the loop re-plans if a step
    does not drain)."""
    n_pix = cfg.width * cfg.height
    dev = scene.device
    n_total = 2 * mb * cur_spp
    pool = int(np.clip(n_total // 32, 1 << 12, 1 << 15))
    pix2 = stratified_pixels(n_pix, mb, 0, dev).repeat(2 * cur_spp)
    samp = torch.arange(2 * cur_spp, dtype=torch.int64,
                        device=dev).repeat_interleave(mb)
    k, _ = wavefront.plan_stream_segments(scene, params, cfg, pix2, samp,
                                          pool, deferred=True)
    return int(k * 1.15) + 2, pool


def stream_grad(diff: dict, scene, params, cfg, pix, target, step: int,
                cur_spp: int, n_seg: int, pool: int, on_lap=_no_lap):
    """The stream method's loss and gradients: the same estimator as
    lockstep_grad. The value comes from a forward-only per-ray pass
    (wavefront.stream_radiance); the gradient (I_B - t) dI_A + (I_A - t)
    dI_B is one weighted stream_loss fold, each ray's term the other
    set's per-pixel error (a constant) times its radiance, so no per-pixel
    binning enters the differentiated graph. Returns (loss, {key: grad},
    n_done, n_total), n_done the smaller of the two passes' counts.
    on_lap(part) is called after "radiance", "loss_forward" and
    "backward"."""
    mb = pix.shape[0]
    dev = pix.device
    tgt = target[pix]
    n_total = 2 * mb * cur_spp
    pix2 = pix.repeat(2 * cur_spp)
    sid = (step * 2 * cur_spp
           + torch.arange(2 * cur_spp, dtype=torch.int64, device=dev))
    samp = sid.repeat_interleave(mb)

    s_g, p_g = graft(diff, scene, params)
    rad, nd_f = wavefront.stream_radiance(s_g, p_g, cfg, pix2, samp, pool,
                                          n_seg)
    i_ab = rad.reshape(2, cur_spp, mb, 3).mean(1)
    loss = torch.mean((i_ab[0] - tgt) * (i_ab[1] - tgt))
    scale = 1.0 / (cur_spp * mb * 3)
    weight = torch.cat([((i_ab[1] - tgt) * scale).repeat(cur_spp, 1),
                        ((i_ab[0] - tgt) * scale).repeat(cur_spp, 1)])
    zeros_t = torch.zeros((n_total, 3), dtype=torch.float32, device=dev)
    on_lap("radiance")
    diff = {k: v.detach().requires_grad_(True) for k, v in diff.items()}
    with torch.enable_grad():
        wl, nd_g = loss_fn_stream(diff, scene, params, cfg, pix2, samp,
                                  zeros_t, pool, n_seg, deferred=True,
                                  weight=weight)
        on_lap("loss_forward")
        grads = torch.autograd.grad(wl, list(diff.values()))
    on_lap("backward")
    return (loss, dict(zip(diff, grads)), min(int(nd_f), int(nd_g)),
            n_total)


def _save_ckpt(ckpt_dir: str, step: int, diff: dict, opt) -> None:
    """The diff tensors, Adam's state and the step, written to a temporary
    name and renamed over the last checkpoint."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, CKPT_NAME)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"step": step,
                "diff": {k: v.detach().cpu() for k, v in diff.items()},
                "opt": opt.state_dict()}, tmp)
    os.replace(tmp, path)


def _load_ckpt(ckpt_dir: str):
    path = os.path.join(ckpt_dir, CKPT_NAME)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu")


def run_optimization(session, target_path: str, steps: int = 100,
                     lr: float = 1e-2, spp: int = 4,
                     out_dir: str = "out/optimize",
                     diff_keys=("kd",), log_every: int = 10,
                     checkpoint_every: int = 50, resume: bool = True,
                     minibatch: int = 0, method: str = "auto"):
    """Adam on the selected scene parameters against a linear .hdr target,
    checkpointing (parameters, optimizer state, step) every
    `checkpoint_every` steps for restart; minibatch = pixels a step (0:
    the full frame). Writes `loss_history.npy` and `opt_{key}.npy` to
    out_dir. Returns ({key: tensor}, loss history).

    method: "lockstep" takes gradients through the checkpointed lockstep;
    "stream" through the streaming wavefront's loss (the same
    paired-sample gradient as weighted per-ray folds); "auto" picks the
    stream on a CUDA session and the lockstep on the CPU, as the JAX
    package picks by its backend."""
    from fluctus_tpu_torch.io.hdr import read_hdr

    os.makedirs(out_dir, exist_ok=True)
    scene, params, cfg = session.scene, session.params, session.cfg
    dev = scene.device
    target_img = read_hdr(target_path)
    assert target_img.shape[:2] == (cfg.height, cfg.width), \
        f"target {target_img.shape} vs render {cfg.height}x{cfg.width}"
    target = torch.as_tensor(target_img.reshape(-1, 3).copy(), device=dev)
    n_pix = cfg.width * cfg.height
    mb = n_pix if minibatch <= 0 else min(minibatch, n_pix)

    diff = {k: _DIFF_GETTERS[k](scene, params).detach().clone()
            .requires_grad_(True) for k in diff_keys}
    opt = torch.optim.Adam(list(diff.values()), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)

    ckpt_dir = os.path.abspath(os.path.join(out_dir, "ckpt"))
    start_step = 0
    saved = _load_ckpt(ckpt_dir) if resume else None
    if saved is not None:
        with torch.no_grad():
            for k, v in diff.items():
                v.copy_(saved["diff"][k])
        opt.load_state_dict(saved["opt"])
        start_step = saved["step"] + 1
        print(f"resumed from checkpoint step {saved['step']}")

    method = resolve_method(method, dev)

    history = []
    phases = spp_schedule(steps, spp)
    bounds = np.cumsum([n for n, _ in phases])
    plans = {}
    for i in range(start_step, steps):
        ph = int(np.searchsorted(bounds, i, side="right"))
        cur_spp = phases[min(ph, len(phases) - 1)][1]
        pix = stratified_pixels(n_pix, mb, i, dev)
        if method == "stream":
            if cur_spp not in plans:
                plans[cur_spp] = plan_stream(scene, params, cfg, mb, cur_spp)
            while True:
                n_seg, pool = plans[cur_spp]
                loss, grads, nd, n_total = stream_grad(
                    diff, scene, params, cfg, pix, target, i, cur_spp, n_seg,
                    pool)
                if nd == n_total:
                    break
                # the minibatch outran the planned segments: grow them and
                # run the step again (an under-drained step is dropped, so
                # the gradient stays unbiased)
                plans[cur_spp] = (n_seg + max(2, n_seg // 4), pool)
                print(f"step {i}: re-planned stream segments -> "
                      f"{plans[cur_spp][0]}")
        else:
            loss, grads = lockstep_grad(diff, scene, params, cfg, pix,
                                        target, i, cur_spp)
        for k, v in diff.items():
            v.grad = grads[k]
        opt.step()
        history.append(float(loss))
        if i % log_every == 0:
            print(f"step {i}: loss {history[-1]:.6f} (spp {cur_spp})")
        if checkpoint_every and (i + 1) % checkpoint_every == 0:
            _save_ckpt(ckpt_dir, i, diff, opt)
    hist_path = os.path.join(out_dir, "loss_history.npy")
    if start_step > 0 and os.path.exists(hist_path):
        history = np.load(hist_path).tolist()[:start_step] + history
    np.save(hist_path, np.asarray(history))
    out = {k: v.detach() for k, v in diff.items()}
    for k, v in out.items():
        np.save(os.path.join(out_dir, f"opt_{k}.npy"), v.cpu().numpy())
    if history:
        print(f"final loss {history[-1]:.6f}; results in {out_dir}")
    else:
        print(f"nothing to do (resumed at step {start_step} >= steps)")
    return out, history
