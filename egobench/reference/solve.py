"""Plain PyTorch reference of one request of the two-stage latent solve.

It follows the method of Wang et al., ICCV 2021 (github.com/jianwang-mpi/
GlobalEgoMocap, optimizer.py) as the configuration freezes it, written
from the configuration alone: nothing of the program is imported, and
everything the program derives from the shared inputs is worked out
again here (the folded BatchNorm, the peak crops, their origins and the
crop-mass guard, the windows, the bone lengths, both stages' solves, the
lifts through the cameras and the merge with its smoothing).

- Staging: k x k crops of each (frame, joint) map around its argmax,
  the guard's statistic (the mean share of non-negative mass the crops
  keep) and, where it falls under the bar, k' x k' crops centred at the
  projected estimate and the solver's robust tier.
- Windows of `seq_len` frames at stride seq_len - overlap; a chunk's
  bone-length target is the mean over its frames of the estimate's.
- Stage 1 (local prior, camera frame): z0 = the encoder mean of the
  window's estimate; the energy w3d |p - anchor|^2 + smooth |accel|^2 +
  bone (|bone| - target)^2 - reproj * sum of the crops sampled
  bilinearly at the fisheye projection; fixed-iteration L-BFGS with the
  step candidates probed in one batched call, the first Armijo one
  taken (else the best), a lane moving only where the value improves.
- Stage 2 (global prior, the window's first camera frame): the residual
  form p(z) = anchor + decode(z) - decode(z0), no reprojection.
- The windows merge by a mean of overlapping frames and a Gaussian
  smoothing (sigma, truncate 4, symmetric edges) of the stage-2 result.

Precision, as the configuration states its tier `bfloat16_delta`: the
encoder, the output decodes and the energies in float32, the decodes of
the objective's evaluations in bfloat16, the solver iterating
dz = z - mu in bfloat16 from 0.  `eval_dtype="fp8"` is the control: the
evaluations' decodes in float8 (e4m3, a scale a tensor), the next
precision down.  TF32 is off for every float32 product.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

J = 15
PARENTS = (0, 0, 1, 2, 0, 4, 5, 1, 7, 8, 9, 4, 11, 12, 13)
BN_EPS = 1e-5
LEAK = 0.01


# ---------------------------------------------------------------------------
# the prior
# ---------------------------------------------------------------------------

def fold_bn(state: dict) -> dict:
    """Each conv block's eval-mode BatchNorm folded into its conv: the
    scale gamma / sqrt(var + eps) on the output channels (axis 0 of a
    Conv1d weight, axis 1 of a ConvTranspose1d one)."""
    out = {}
    for key, v in state.items():
        if ".running_var" not in key:
            continue
        bn = key[:-len(".running_var")]
        head, idx = bn.rsplit(".", 1)
        conv = f"{head}.{int(idx) - 1}"
        inv = state[bn + ".weight"] / torch.sqrt(v + BN_EPS)
        w = state[conv + ".weight"]
        transposed = head.startswith("decoder") or conv == "final_layer.0"
        out[conv + ".weight"] = (w * inv[None, :, None] if transposed
                                 else w * inv[:, None, None])
        out[conv + ".bias"] = ((state[conv + ".bias"]
                                - state[bn + ".running_mean"]) * inv
                               + state[bn + ".bias"])
    for key in ("fc_mu", "fc_var", "decoder_input", "final_layer.3"):
        out[key + ".weight"] = state[key + ".weight"]
        out[key + ".bias"] = state[key + ".bias"]
    return out


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at 448), in x's dtype; the gradient passes
    straight through."""
    amax = x.detach().abs().amax().to(torch.float32).clamp_min(1e-30)
    scale = 448.0 / amax
    q = ((x.detach().to(torch.float32) * scale).to(torch.float8_e4m3fn)
         .to(torch.float32) / scale).to(x.dtype)
    return x + (q - x).detach()


class Prior:
    """A folded ConvVAE at one compute dtype ('fp32', 'bf16' or 'fp8':
    bf16 storage with every product's operands rounded to float8)."""

    def __init__(self, folded: dict, prior: dict, dtype: str):
        self.t = prior["seq_len"]
        self.hidden = list(prior["hidden_dims"])
        self.quant = dtype == "fp8"
        self.dt = torch.float32 if dtype == "fp32" else torch.bfloat16
        self.p = {}
        for k, v in folded.items():
            v = v.to(self.dt)
            if self.quant and k.endswith(".weight"):
                v = _fp8(v)
            self.p[k] = v

    def _q(self, x):
        return _fp8(x) if self.quant else x

    def _lin(self, x, name):
        return F.linear(self._q(x), self.p[name + ".weight"],
                        self.p[name + ".bias"])

    def _conv(self, x, name, transposed):
        fn = F.conv_transpose1d if transposed else F.conv1d
        return fn(self._q(x), self.p[name + ".weight"],
                  self.p[name + ".bias"], padding=1)

    def encode_mu(self, pose):
        """pose (B, T, 45) -> the encoder mean (B, latent)."""
        h = pose.to(self.dt).transpose(1, 2)
        for i in range(len(self.hidden)):
            h = F.leaky_relu(self._conv(h, f"encoder.{i}.0", False), LEAK)
        return self._lin(h.flatten(1), "fc_mu")

    def decode(self, z):
        """z (B, latent) -> poses (B, T, 15, 3) in the prior's dtype."""
        h = self._lin(z.to(self.dt), "decoder_input")
        h = h.view(-1, self.hidden[-1], self.t)
        for i in range(len(self.hidden) - 1):
            h = F.leaky_relu(self._conv(h, f"decoder.{i}.0", True), LEAK)
        h = F.leaky_relu(self._conv(h, "final_layer.0", True), LEAK)
        h = self._conv(h, "final_layer.3", False)
        return h.transpose(1, 2).reshape(-1, self.t, J, 3)


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------

def peak_crops(maps: np.ndarray, k: int):
    """k x k crops of (N, H, W, J) maps around each map's argmax:
    (crops (N, k, k, J), origins (N, J, 2) as (oy, ox), per-map share of
    the non-negative mass the crop keeps (N, J))."""
    n, h, w, j = maps.shape
    am = maps.reshape(n, h * w, j).argmax(axis=1)
    oy = np.clip(am // w - k // 2, 0, h - k)
    ox = np.clip(am % w - k // 2, 0, w - k)
    crops = gather_crops(maps, k, oy, ox)
    pos = np.clip(maps.astype(np.float64), 0.0, None)
    box = np.clip(crops.astype(np.float64), 0.0, None).sum(axis=(1, 2))
    total = pos.sum(axis=(1, 2))
    share = np.where(total > 0, box / np.maximum(total, 1e-300), 1.0)
    return crops, np.stack([oy, ox], -1).astype(np.float32), share


def gather_crops(maps, k, oy, ox):
    """crops[n, a, b, j] = maps[n, oy + a, ox + b, j]."""
    n, _, _, j = maps.shape
    rows = oy[:, None, :] + np.arange(k)[None, :, None]      # (N, k, J)
    cols = ox[:, None, :] + np.arange(k)[None, :, None]
    ni = np.arange(n)[:, None, None, None]
    ji = np.arange(j)[None, None, None, :]
    return maps[ni, rows[:, :, None, :], cols[:, None, :, :], ji]


def fisheye_pixels(points: torch.Tensor, camera: dict) -> torch.Tensor:
    """Camera-frame points (..., 3) -> fisheye pixels (..., 2), float32:
    theta = atan(-z / |xy|), rho = poly(theta) (Horner from the highest
    coefficient), |xy| clamped at 1e-9."""
    poly = torch.tensor(camera["polynomialW2C"], dtype=torch.float32,
                        device=points.device)
    cx = float(np.float32(camera["intrinsic"][0][2]))
    cy = float(np.float32(camera["intrinsic"][1][2]))
    x, y, z = points[..., 0], points[..., 1], -points[..., 2]
    # |xy| with a finite derivative on the optical axis, where a bf16
    # decode can put a joint exactly
    sq = x * x + y * y
    norm = (torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))
            * (sq > 0)).clamp_min(1e-9)
    theta = torch.atan(z / norm)
    rho = torch.zeros_like(theta)
    for c in poly.flip(0):
        rho = rho * theta + c
    inv = rho / norm
    return torch.stack([x * inv + cx, y * inv + cy], dim=-1)


def estimate_crops(maps: np.ndarray, est_local: np.ndarray, k: int,
                   camera: dict, crop_offset: float, half: float):
    """k x k crops centred at the projection of the estimate: the map
    pixel of grid coordinate (p - (crop_offset + half, half)) / half,
    rounded, the crop clipped to the map.  -> (crops, origins)."""
    n, h, w, _ = maps.shape
    p2d = fisheye_pixels(torch.from_numpy(est_local.astype(np.float32)),
                         camera)
    off = torch.tensor([crop_offset + half, half], dtype=torch.float32)
    grid = (p2d - off) / half
    cx = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    cy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    c = np.round(torch.stack([cy, cx], -1).numpy()).astype(np.int64)
    oy = np.clip(c[..., 0] - k // 2, 0, h - k)
    ox = np.clip(c[..., 1] - k // 2, 0, w - k)
    return (gather_crops(maps, k, oy, ox),
            np.stack([oy, ox], -1).astype(np.float32))


# ---------------------------------------------------------------------------
# energy and solver
# ---------------------------------------------------------------------------

def energy(pose, anchor, bone, w, crops=None, org=None, camera=None,
           full_hw=None, crop_offset=128.0, half=512.0):
    """Per-window energy (R, B) of poses (R, B, T, 15, 3) float32.
    anchor (B, T, 15, 3), bone (B, 15), w = (w3d, smooth, bone, reproj);
    crops (B, T, 15, k, k) float32 with origins (B, T, 15, 2) (oy, ox)
    for the reprojection term."""
    w3d, w_sm, w_bone, w_rep = w
    e = w3d * ((pose - anchor) ** 2).sum((-3, -2, -1))
    acc = pose[:, :, 2:] - 2.0 * pose[:, :, 1:-1] + pose[:, :, :-2]
    e = e + w_sm * (acc ** 2).sum((-3, -2, -1))
    bones = pose - pose[..., list(PARENTS), :]
    sq = (bones ** 2).sum(-1)
    nz = sq > 0
    length = torch.sqrt(torch.where(nz, sq, torch.ones_like(sq))) * nz
    e = e + w_bone * ((length - bone[:, None, :]) ** 2).sum((-2, -1))
    if crops is None:
        return e
    k = crops.shape[-1]
    fh, fw = full_hw
    p2d = fisheye_pixels(pose, camera)
    ix = (p2d[..., 0] - crop_offset) * ((fw - 1) / (2.0 * half)) \
        - org[..., 1]
    iy = p2d[..., 1] * ((fh - 1) / (2.0 * half)) - org[..., 0]
    cell = torch.arange(k, device=pose.device, dtype=pose.dtype)
    wx = (1.0 - (ix[..., None] - cell).abs()).clamp_min(0.0)  # (..., k)
    wy = (1.0 - (iy[..., None] - cell).abs()).clamp_min(0.0)
    s = (crops * wy[..., :, None] * wx[..., None, :]).sum((-2, -1))
    return e - w_rep * s.sum((-2, -1))


def _dot(a, b):
    """Row-wise dot in float32, rounded to the inputs' dtype."""
    return (a.to(torch.float32) * b.to(torch.float32)).sum(-1).to(a.dtype)


def two_loop(g, s, y, rho, valid):
    """The L-BFGS direction -H g from histories ordered oldest..newest."""
    m = s.shape[1]
    q, alphas = g, [None] * m
    for i in reversed(range(m)):
        a = rho[:, i] * _dot(s[:, i], q)
        a = torch.where(valid[:, i], a, torch.zeros_like(a))
        q = q - a[:, None] * y[:, i]
        alphas[i] = a
    sy = (s[:, -1] * y[:, -1]).sum(-1)
    yy = (y[:, -1] * y[:, -1]).sum(-1)
    gamma = torch.where(valid[:, -1] & (yy > 0), sy / yy,
                        torch.ones_like(sy))
    r = gamma[:, None] * q
    for i in range(m):
        b = rho[:, i] * _dot(y[:, i], r)
        upd = s[:, i] * (alphas[i] - b)[:, None]
        r = r + torch.where(valid[:, i, None], upd, torch.zeros_like(upd))
    return -r


def _push(hist, row, keep):
    rolled = torch.cat([hist[:, 1:], row[:, None]], dim=1)
    return torch.where(keep.view((-1,) + (1,) * (hist.dim() - 1)), rolled,
                       hist)


def lbfgs_fixed(vg, x0, iters, history, lr, candidates, c1=1e-4):
    """Fixed-iteration L-BFGS over the lanes of x0 (B, d); vg maps probes
    (K, B, d) to (values (K, B), gradients (K, B, d))."""
    b, d = x0.shape
    dt, dev = x0.dtype, x0.device
    cands = torch.tensor(candidates, dtype=dt, device=dev) * lr
    f, g = vg(x0[None])
    x, f, g = x0, f[0], g[0]
    first = (1.0 / g.abs().sum(-1)).clamp(max=1.0).to(dt)
    s_h = torch.zeros((b, history, d), dtype=dt, device=dev)
    y_h = torch.zeros_like(s_h)
    rho = torch.zeros((b, history), dtype=dt, device=dev)
    valid = torch.zeros((b, history), dtype=torch.bool, device=dev)
    lanes = torch.arange(b, device=dev)
    for it in range(iters):
        dirn = two_loop(g, s_h, y_h, rho, valid)
        ok = ((dirn * g).sum(-1) < 0) & torch.isfinite(dirn).all(-1)
        dirn = torch.where(ok[:, None], dirn, -g)
        slope = (dirn * g).sum(-1)
        scale = first if it == 0 else torch.ones_like(first)
        ts = cands[:, None] * scale[None, :]
        fs, gs = vg(x[None] + ts[:, :, None] * dirn[None])
        fs = torch.where(torch.isfinite(fs), fs, torch.full_like(fs, np.inf))
        armijo = fs <= f[None] + c1 * ts * slope[None]
        pick = torch.where(armijo.any(0),
                           torch.argmax(armijo.to(torch.uint8), dim=0),
                           torch.argmin(fs, dim=0))
        f_sel, t_sel = fs[pick, lanes], ts[pick, lanes]
        better = f_sel < f
        step = torch.where(better, t_sel, torch.zeros_like(t_sel))[:, None] \
            * dirn
        x = x + step
        g_new = torch.where(better[:, None], gs[pick, lanes], g)
        f_new = torch.where(better, f_sel, f)
        yv = g_new - g
        ys = (yv * step).sum(-1)
        keep = ys > 1e-10
        s_h, y_h = _push(s_h, step, keep), _push(y_h, yv, keep)
        rho = _push(rho, 1.0 / ys, keep)
        valid = _push(valid, torch.ones_like(keep), keep)
        f, g = f_new, g_new
    return x


def solve_stage(f32, ev, anchor, bone, w, solver, residual=False,
                **reproj):
    """One stage over windows: anchor (B, T, 15, 3) float32 -> the decoded
    optimised poses (B, T, 15, 3) float32.  `f32` encodes and decodes the
    output, `ev` decodes the objective's evaluations."""
    bsz, t = anchor.shape[:2]
    with torch.no_grad():
        mu = f32.encode_mu(anchor.reshape(bsz, t, 3 * J))
        offset = anchor - f32.decode(mu) if residual else None

    def pose_of(dec, z):
        p = dec.decode(z.reshape(-1, z.shape[-1]))
        p = p.reshape(z.shape[:-1] + (t, J, 3))
        return p.to(torch.float32) if offset is None else p + offset

    def vg(z3):
        with torch.enable_grad():
            z = z3.detach().requires_grad_(True)
            vals = energy(pose_of(ev, z.to(torch.float32) + mu), anchor,
                          bone, w, **reproj)
            (grad,) = torch.autograd.grad(vals.sum(), z)
        return vals.detach(), grad

    dz = lbfgs_fixed(vg, torch.zeros_like(mu, dtype=torch.bfloat16),
                     solver["iters"], solver["history"], solver["lr"],
                     solver["candidates"])
    with torch.no_grad():
        return pose_of(f32, dz.to(torch.float32) + mu)


# ---------------------------------------------------------------------------
# geometry and merge
# ---------------------------------------------------------------------------

def invert_se3(m):
    r_t = m[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(m)
    out[..., :3, :3] = r_t
    out[..., :3, 3:] = -(r_t @ m[..., :3, 3:])
    out[..., 3, 3] = 1.0
    return out


def apply_se3(pose, m):
    """pose (..., 15, 3), m (..., 4, 4) -> R p + t."""
    return pose @ m[..., :3, :3].transpose(-1, -2) + m[..., None, :3, 3]


def merge_matrix(w, t, stride, sigma):
    """(covered, W*T) float32: the mean of overlapping window frames,
    then (sigma > 0) a Gaussian of radius int(4 sigma + 0.5) with
    symmetric edges."""
    n = (w - 1) * stride + t
    idx = (np.arange(w) * stride)[:, None] + np.arange(t)[None, :]
    m = np.zeros((n, w * t), np.float64)
    m[idx.reshape(-1), np.arange(w * t)] = 1.0
    m /= m.sum(1, keepdims=True)
    if sigma > 0:
        r = int(4.0 * sigma + 0.5)
        x = np.arange(-r, r + 1, dtype=np.float64)
        ker = np.exp(-0.5 * x ** 2 / sigma ** 2)
        ker /= ker.sum()
        s = np.zeros((n, n))
        for i in range(n):
            for o in range(-r, r + 1):
                j = i + o
                j = -j - 1 if j < 0 else (2 * n - j - 1 if j >= n else j)
                s[i, j] += ker[o + r]
        m = s @ m
    return m.astype(np.float32)


# ---------------------------------------------------------------------------
# one request
# ---------------------------------------------------------------------------

def solver_of(opt: dict, robust: bool) -> tuple:
    """(stage-1, stage-2) solver settings of the configuration, robust
    tier or not (history >= 10, >= 15 stage-1 iterations, four step
    candidates)."""
    s = opt["solver"]
    hist, iters, cands = s["history_size"], s["max_iter"], \
        tuple(s["step_candidates"])
    if robust:
        hist, iters = max(hist, 10), max(iters, 15)
        cands = (1.0, 0.5, 0.1, 0.02)
    if s.get("unchanged"):
        iters = 0
    one = {"iters": iters, "history": hist, "lr": s["lr"],
           "candidates": cands}
    return one, dict(one, iters=0 if s.get("unchanged")
                     else s["global_max_iter"])


def unchanged(opt: dict) -> dict:
    """The configuration with both stages' iterations at 0: the answer of
    a solve whose state never moves from its start."""
    return dict(opt, solver=dict(opt["solver"], unchanged=True))


def stage_request(chunks: list, opt: dict, camera: dict,
                  coverage: float | None = None) -> dict:
    """The staging of one request: the peak crops' guard statistic
    (`coverage` when given, as a stream's later requests take the first
    one's), the guard's decision, and the crops (C, N, k*k*15) bfloat16
    with their origins (C, N, 15, 2)."""
    k = opt["heatmap_crop"]
    peaks = [peak_crops(c["heatmaps"], k) for c in chunks]
    if coverage is None:
        coverage = float(np.mean([p[2].mean() for p in peaks]))
    tripped = coverage < opt["heatmap_crop_min_mass"]
    if tripped:
        kk = opt["guard_crop"]
        cut = [estimate_crops(c["heatmaps"], c["estimated_local"], kk,
                              camera, opt["heatmap"]["crop_offset"],
                              opt["heatmap"]["half_extent"])
               for c in chunks]
    else:
        kk, cut = k, [(p[0], p[1]) for p in peaks]
    crops = torch.from_numpy(np.stack([c for c, _ in cut]))
    crops = crops.reshape(crops.shape[:2] + (-1,)).to(torch.bfloat16)
    return {"coverage": coverage, "tripped": bool(tripped), "k": kk,
            "crops": crops, "origins": torch.from_numpy(
                np.stack([o for _, o in cut]))}


def solve_request(chunks: list, staged: dict, local: dict, glob: dict,
                  opt: dict, camera: dict, device, eval_dtype="bf16"
                  ) -> dict:
    """Both stages of a request of equal-length chunks (dicts of numpy
    arrays) on `device`, from the raw priors' state dicts: the merged
    stage-1 camera-frame poses 'mid_local' and the merged, smoothed
    world poses 'optimized', each (C, covered, 15, 3) float32."""
    prior = opt["prior"]
    t, stride = opt["window"]["seq_len"], \
        opt["window"]["seq_len"] - opt["window"]["overlap"]
    e = opt["energy"]
    s1, s2 = solver_of(opt, staged["tripped"])
    priors = []
    for state in (local, glob):
        folded = fold_bn({k: v.to(device, torch.float32)
                          for k, v in state.items()
                          if v.is_floating_point()})
        priors.append((Prior(folded, prior, "fp32"),
                       Prior(folded, prior, eval_dtype)))
    est = torch.from_numpy(np.stack([c["estimated_local"] for c in chunks]))
    cams = torch.from_numpy(np.stack([c["camera_poses"] for c in chunks]))
    est, cams = est.to(device), cams.to(device)
    c, n = est.shape[:2]
    nw = (n - t) // stride + 1
    idx = torch.as_tensor(((np.arange(nw) * stride)[:, None]
                           + np.arange(t)[None, :]).reshape(-1),
                          device=device)

    def windows(x):                        # (C, N, ...) -> (C*W, T, ...)
        return x.index_select(1, idx).reshape((c * nw, t) + x.shape[2:])

    bones = est - est[..., list(PARENTS), :]
    sq = (bones ** 2).sum(-1)
    length = torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq))) \
        * (sq > 0)
    bone = length.mean(1).repeat_interleave(nw, dim=0)          # (CW, 15)
    k = staged["k"]
    crops = staged["crops"].to(device).to(torch.float32).reshape(
        c, n, k, k, J).permute(0, 1, 4, 2, 3)
    w_local = (e["weight_3d"] / 1e4, e["smooth"] / 100.0, e["bone_length"],
               e["reproj"])
    hm = opt["heatmap"]
    mid = solve_stage(
        *priors[0], windows(est), bone, w_local, s1,
        crops=windows(crops), org=windows(staged["origins"].to(device)),
        camera=camera, full_hw=(64, 64), crop_offset=hm["crop_offset"],
        half=hm["half_extent"])
    wcam = windows(cams)
    rel = invert_se3(wcam[:, :1]) @ wcam
    mid_rel = apply_se3(mid, rel)
    g3d = e["weight_3d"] if e["global_weight_3d"] is None \
        else e["global_weight_3d"]
    gsm = e["smooth"] if e["global_smooth"] is None else e["global_smooth"]
    opt_rel = solve_stage(*priors[1], mid_rel, bone, (g3d, gsm, 0.01, 0.0),
                          s2, residual=True)
    opt_world = apply_se3(opt_rel, wcam[:, :1])
    merge = torch.from_numpy(merge_matrix(nw, t, stride, 0.0)).to(device)
    smooth = torch.from_numpy(merge_matrix(
        nw, t, stride, opt["final_smooth_sigma"])).to(device)

    def merged(x, m):
        return (m @ x.reshape(c, nw * t, J * 3)).reshape(c, -1, J, 3)

    return {"mid_local": merged(mid, merge).cpu(),
            "optimized": merged(opt_world, smooth).cpu()}
