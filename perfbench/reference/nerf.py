"""The hierarchical NeRF as AtmoNR publishes it: NeRF (Mildenhall et al.
2020, arXiv:2003.08934) adapted to atmospheric scenes in
https://github.com/nasa/atmospheric-neural-rendering
(``configs/nerf.json``, ``src/atmonr/pipelines/nerf.py``), in plain
float32 PyTorch.

A train step on a batch of rays:

- coarse depths: one sample uniformly in each of ``N_c`` equal bins of
  the ray, ``z_i = (i / N_c + t_i / N_c) * len``;
- the point preprocessor (``scene.Scene.preprocess``: normalized latitude,
  longitude and altitude in [-1, 1]) and the frequency encodings
  ``sin(2^l pi x)``, ``cos(2^l pi x)``: the points with ``L_x`` frequencies
  an axis, in blocks [sin_0..sin_{L-1}, cos_0..cos_{L-1}] an axis, the view
  direction with ``L_d``, [sin_l, cos_l] interleaved a frequency;
- AtmoNeRF: ``h_1 = relu(W_1 x + b_1)``, ..., ``h_5``;
  ``h_6 = relu(W_6 [h_5, x] + b_6)`` (the positional skip), ``h_7``,
  ``h_8``; ``f = W_9 h_8 + b_9`` (width + density channels); ``sigma =
  relu(f[width:] + noise)``; ``h_10 = relu(W_10 [f[:width], d] + b_10)``;
  ``c = exp(sigmoid(W_11 h_10 + b_11))``. The coarse model has one density
  channel, the fine one a band;
- Beer-Lambert compositing with z in km: midpoint deltas with 0 before the
  first sample and the last depth after the last, ``alpha = 1 -
  exp(-sigma delta)``, ``T_i = prod_{j<i}(1 - alpha_j + 1e-10)``, ``w =
  alpha T``, ``C = sum w c``;
- fine depths: the coarse weights of the inner samples plus 1e-8 as a
  piecewise-linear CDF over the coarse midpoints, ``N_f`` quantiles ``u``
  inverted through it (the bin width carries no gradient), merged with the
  coarse depths and sorted; the fine model evaluates all ``N_c + N_f``;
- the loss: the coarse plus the fine mean squared error of each ray's
  radiance in its own band;
- Adam (Kingma and Ba) as PyTorch applies it: betas 0.9 / 0.999, eps 1e-8
  outside the square root, no weight decay, no clip, at the rate of the
  configuration's schedule and warm-up.

Departures from the published description, each made so that the
reference rounds as the program does where a last bit matters (at 2^13 pi
an ulp of a depth is a visible angle):

- the bin edges are ``i * (1 / N_c)``, the reciprocal rounded once, and the
  frequencies ``2^l * pi`` in float32;
- the color's exp is clamped at 11 before it is taken (a no-op after the
  sigmoid, which the published code keeps against fp16 overflow);
- ``fine_depths`` takes the program's fine depths where given
  (``given``): the value is the program's, the gradient the reference's own
  through its own inverse CDF. The depths themselves are compared apart.

Everything computes in float32 with TF32 off (``float32_matmul``);
``gemm="tf32"`` or ``"bf16"`` computes the products in a lower precision
instead (the controls). Imports nothing of the program under test."""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

MODELS = ("coarse", "fine")


@contextmanager
def float32_matmul(allow_tf32: bool = False):
    """TF32 off for the block (on with ``allow_tf32``); the settings as
    they were afterwards."""
    cuda, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def channels(pipeline_cfg: dict) -> tuple[int, int]:
    """(position, direction) channels of the encodings (``L_x`` one count
    an axis, as the configuration gives it)."""
    enc = pipeline_cfg["encoder"]
    return 2 * sum(int(n) for n in enc["L_x"]), 6 * int(enc["L_d"])


def param_shapes(pipeline_cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter by name: ``<model>.fc<i>.weight`` (out, in) and
    ``.bias`` (out,) of fc1..fc11, the coarse model first."""
    pos, dirs = channels(pipeline_cfg)
    h, bands = int(pipeline_cfg["mlp_hidden_dim"]), int(pipeline_cfg["num_bands"])
    out = {}
    for model, volume in zip(MODELS, (1, bands)):
        dims = ([(h, pos)] + [(h, h)] * 4 + [(h, h + pos)] + [(h, h)] * 2
                + [(h + volume, h), (h // 2, h + dirs), (bands, h // 2)])
        for i, (o, n) in enumerate(dims, 1):
            out[f"{model}.fc{i}.weight"] = (o, n)
            out[f"{model}.fc{i}.bias"] = (o,)
    return out


def lr_schedule(trainer_cfg: dict, n_rays: int):
    """The learning rate of the optimizer's step count (0 first): the
    configuration's ``target_lr`` schedule, a factor a whole epoch that
    lands on ``final_lr`` after the last, behind its linear warm-up."""
    opt, sched = trainer_cfg["optimizer"], trainer_cfg["scheduler"]
    if sched["type"] != "target_lr":
        raise NotImplementedError(sched["type"])
    lr0 = float(opt["lr"])
    per_epoch = max(1, n_rays // int(trainer_cfg["batch_size"]))
    epochs = -(-int(trainer_cfg["num_iters"]) // per_epoch)
    gamma = (float(sched["final_lr"]) / lr0) ** (1.0 / epochs)
    warmup = int(opt.get("warmup_iters", 0))
    return lambda step: lr0 * gamma ** (step // per_epoch) * (
        min(1.0, (step + 1) / warmup) if warmup else 1.0)


class Adam:
    """Adam with bias correction, eps outside the square root; from
    moments ``m``, ``v`` after ``t`` steps where given, else from zero."""

    def __init__(self, params: dict, schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, m: dict | None = None, v: dict | None = None, t: int = 0):
        self.p, self.schedule, self.b1, self.b2, self.eps = params, schedule, b1, b2, eps
        self.m = {k: torch.zeros_like(x) if m is None else m[k].clone() for k, x in params.items()}
        self.v = {k: torch.zeros_like(x) if v is None else v[k].clone() for k, x in params.items()}
        self.t = t

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        lr = self.schedule(self.t)
        self.t += 1
        c1, c2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        for k, p in self.p.items():
            g = grads[k]
            self.m[k].lerp_(g, 1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def _frequencies(n: int, like: torch.Tensor) -> torch.Tensor:
    return 2.0 ** torch.arange(n, dtype=like.dtype, device=like.device) * math.pi


class Model:
    """The configuration's hierarchical NeRF over a ``scene.Scene``."""

    def __init__(self, pipeline_cfg: dict, scene, gemm: str | None = None):
        self.scene = scene
        self.n_c = int(pipeline_cfg["sampler"]["N_c"])
        self.n_f = int(pipeline_cfg["sampler"]["N_f"])
        self.l_x = pipeline_cfg["encoder"]["L_x"]
        self.l_d = int(pipeline_cfg["encoder"]["L_d"])
        self.width = int(pipeline_cfg["mlp_hidden_dim"])
        self.gemm = gemm

    def linear(self, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = p[name + ".weight"], p[name + ".bias"]
        if self.gemm == "bf16":
            return (x.to(torch.bfloat16) @ w.to(torch.bfloat16).T).to(x.dtype) + b
        return x @ w.T + b

    def encode(self, pts: torch.Tensor, dirs: torch.Tensor):
        """(M, 3) normalized points and unit directions -> their encodings."""
        x = self.scene.preprocess(pts)
        blocks = []
        for axis, n in enumerate(self.l_x):
            a = x[:, axis, None] * _frequencies(n, x)
            blocks += [torch.sin(a), torch.cos(a)]
        a = dirs[..., None] * _frequencies(self.l_d, dirs)
        d = torch.stack([torch.sin(a), torch.cos(a)], -1).reshape(dirs.shape[0], -1)
        return torch.cat(blocks, -1), d

    def atmonerf(self, p: dict, model: str, x: torch.Tensor, d: torch.Tensor,
                 noise: torch.Tensor | None):
        """(color (M, bands), sigma (M, density channels))."""
        h = x
        for i in range(1, 9):
            h = torch.relu(self.linear(p, f"{model}.fc{i}", h))
            if i == 5:
                h = torch.cat([h, x], -1)
        f = self.linear(p, f"{model}.fc9", h)
        sigma = f[:, self.width:]
        if noise is not None:
            sigma = sigma + noise
        h = torch.relu(self.linear(p, f"{model}.fc10", torch.cat([f[:, :self.width], d], -1)))
        color = torch.exp(torch.clamp(torch.sigmoid(self.linear(p, f"{model}.fc11", h)),
                                      max=11.0))
        return color, torch.relu(sigma)

    def composite(self, z: torch.Tensor, color: torch.Tensor, sigma: torch.Tensor):
        """(color map (B, bands), weights (B, N, channels)), z in km."""
        zk = z * (self.scene.scale / 1000.0)
        mid = torch.cat([zk[:, :1] * 0, (zk[:, :-1] + zk[:, 1:]) * 0.5, zk[:, -1:]], -1)
        delta = torch.diff(mid, dim=-1)[..., None]
        alpha = 1.0 - torch.exp(-sigma * delta)
        trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], 1),
                              1)[:, :-1]
        w = alpha * trans
        return torch.sum(color * w, 1), w

    def fine_depths(self, z_c: torch.Tensor, weights: torch.Tensor, u: torch.Tensor):
        """The coarse and the inverse-CDF depths, merged and sorted."""
        w = weights[:, 1:-1, 0] + 1e-8
        cdf = torch.cumsum(w / torch.sum(w, 1, keepdim=True), 1)
        cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], 1)
        i = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
        lo, hi = torch.clamp(i - 1, min=0), torch.clamp(i, max=cdf.shape[1] - 1)
        mid = 0.5 * (z_c[:, 1:] + z_c[:, :-1])
        c_lo, c_hi = torch.gather(cdf, 1, lo), torch.gather(cdf, 1, hi)
        z_lo, z_hi = torch.gather(mid, 1, lo), torch.gather(mid, 1, hi)
        span = c_hi - c_lo
        span = torch.where(span < 1e-8, torch.ones_like(span), span)
        z_f = z_lo + (u - c_lo) / span * (z_hi - z_lo).detach()
        return torch.sort(torch.cat([z_c, z_f], -1), -1).values

    def render(self, p: dict, rays: dict, draws: dict, given: torch.Tensor | None = None):
        """Both passes over a batch: the coarse and fine color maps (B,
        bands) and the reference's own fine depths (B, N_c + N_f); the fine
        pass at ``given`` depths where they are given."""
        o, d, ln = rays["origin"], rays["dir"], rays["len"]
        b, n = o.shape[0], self.n_c
        bins = torch.arange(n, dtype=o.dtype, device=o.device) * (1.0 / n)
        z_c = (bins[None] + draws["coarse_bins"] / n) * ln[:, None]
        out = {}
        z = z_c
        for model, noise in zip(MODELS, ("coarse_noise", "fine_noise")):
            m = z.shape[1]
            pts = o[:, None] + d[:, None] * z[..., None]
            x, e = self.encode(pts.reshape(-1, 3), d[:, None].expand(b, m, 3).reshape(-1, 3))
            color, sigma = self.atmonerf(p, model, x, e, draws[noise])
            out[model], weights = self.composite(z, color.reshape(b, m, -1),
                                                 sigma.reshape(b, m, -1))
            if model == "coarse":
                z = out["z_fine"] = self.fine_depths(z_c, weights, draws["fine_u"])
                if given is not None:
                    z = given + (z - z.detach())
        return out

    def loss_and_grads(self, p: dict, rays: dict, draws: dict,
                       given: torch.Tensor | None = None, terms: tuple = MODELS,
                       rows: int | None = None):
        """(the loss, its gradient by parameter, the reference's own fine
        depths), forward and backward in the reference's precision. The
        loss sums the ``terms`` passes' errors, each the mean over the first
        ``rows`` rays (all where None)."""
        with float32_matmul(self.gemm == "tf32"):
            out = self.render(p, rays, draws, given)
            band = rays["band"][:rows, None].long()
            loss = 0.0
            for model in terms:
                pred = torch.gather(out[model][:rows], 1, band)[:, 0]
                loss = loss + torch.mean((pred - rays["rad"][:rows]) ** 2)
            grads = torch.autograd.grad(loss, list(p.values()), materialize_grads=True)
        return loss.detach(), dict(zip(p, grads)), out["z_fine"].detach()
