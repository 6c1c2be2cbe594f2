"""Sample-quality harness: FID, Inception Score, SSIM, PSNR and the
negative log-likelihood (counterpart of the reference's
``utils/benchmarks.py``).

Features and logits are computed on the model's device, by InceptionV3
(``utils/inception.py``) when a weights file is given, else by a fixed
random conv net drawn from a seed. The random extractor's scores order
models and are comparable across runs of this package; its weights come
from a ``torch.Generator``, not from the reference's ``PRNGKey``, so its
numbers are not the reference's default numbers. Extraction runs in
true f32 (:func:`f32_extraction`: no TF32, which PyTorch's default lets
cuDNN's convs use). The Fréchet distance runs on the host in float64, as
the reference's does.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .inception import nhwc_to_nchw3, resize_bilinear

_SEED_STRIDE = 1_000_003
SAMPLERS = {"dpm++": "generate_samples_dpm",
            "heun": "generate_samples_heun",
            "strided": "generate_samples_strided"}


def _generator(device: torch.device, seed: int, index: int
               ) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, index)."""
    return torch.Generator(device=device).manual_seed(
        (seed * _SEED_STRIDE + index) & (2 ** 63 - 1))


def same_pads(size: int, kernel: int, stride: int):
    """XLA's "SAME" padding (before, after) of one spatial dim: the total
    (out − 1)·stride + kernel − size, with the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


# ---------------------------------------------------------------------------
# Feature extractors
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def f32_extraction():
    """TF32 off for cuDNN's convs and cuBLAS's matmuls while the block
    runs, then the caller's settings back: PyTorch's default
    (``cudnn.allow_tf32``) would run the extractor's convs with 10-bit
    mantissas, which moves InceptionV3's features far more than the
    harness's 1e-4 relative bound (``chip_smoke.py`` phase 13a)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class FeatureExtractor(nn.Module):
    """Fixed random conv net: NHWC images in [−1, 1] → (pooled features
    [B, feature_dim], logits [B, num_classes]).

    One channel is repeated to three; the images are resized bilinearly
    to 64² (antialiased when shrinking, as ``jax.image.resize``), then
    five 3×3 stride-2 convs with XLA's SAME padding, each with a ReLU,
    a global average pool and a fixed linear head. Weights are He-normal
    draws from a CPU ``torch.Generator(seed)``.
    """

    WIDTHS = (64, 128, 256, 512)

    def __init__(self, seed: int = 0, feature_dim: int = 2048,
                 num_classes: int = 1000,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        from ..models.base import resolve_device
        gen = torch.Generator().manual_seed(seed)
        widths = self.WIDTHS + (feature_dim,)
        self.convs = nn.ModuleList()
        cin = 3
        for w in widths:
            conv = nn.Conv2d(cin, w, 3, 2, bias=False)
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape,
                                              generator=gen)
                                  * (2.0 / (9 * cin)) ** 0.5)
            self.convs.append(conv)
            cin = w
        self.head = nn.Parameter(
            torch.randn((feature_dim, num_classes), generator=gen)
            * feature_dim ** -0.5, requires_grad=False)
        self.device = resolve_device(device)
        self.to(self.device).eval()

    @torch.no_grad()
    def forward(self, images):
        h = resize_bilinear(nhwc_to_nchw3(images, self.device), 64)
        for conv in self.convs:
            pt, pb = same_pads(h.shape[2], 3, 2)
            pl, pr = same_pads(h.shape[3], 3, 2)
            h = F.relu(conv(F.pad(h, (pl, pr, pt, pb))))
        feats = h.mean(dim=(2, 3))
        return feats, feats @ self.head


def make_extractor(use_inception: bool = False, seed: int = 0,
                   weights_path: Optional[str] = None,
                   device: Union[str, torch.device, None] = None):
    """The feature extractor. ``use_inception`` takes InceptionV3 with the
    weights in ``weights_path`` or ``$DMU_INCEPTION_WEIGHTS`` (a reference
    ``.npz`` or a torchvision ``.pth``); without such a file it warns and
    falls back to the seeded random extractor, as the reference does."""
    if use_inception:
        path = weights_path or os.environ.get("DMU_INCEPTION_WEIGHTS", "")
        if path and os.path.exists(path):
            from .inception import InceptionExtractor
            return InceptionExtractor(weights_path=path, device=device)
        print("[benchmarks] InceptionV3 unavailable (no weights file); set "
              "DMU_INCEPTION_WEIGHTS=<converted .npz> for real FID/IS "
              "(scripts/convert_weights.py). Falling back to the fixed "
              "random extractor (scores comparable across runs, not to "
              "the literature)")
    return FeatureExtractor(seed=seed, device=device)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def _f64(feats) -> np.ndarray:
    if isinstance(feats, torch.Tensor):
        feats = feats.detach().cpu().numpy()
    return np.asarray(feats, np.float64)


def covariance(feats) -> np.ndarray:
    """Unbiased covariance of [N, D] features, float64 on the host."""
    feats = _f64(feats)
    centered = feats - feats.mean(axis=0, keepdims=True)
    return centered.T @ centered / (feats.shape[0] - 1)


def frechet_distance(feats1, feats2) -> float:
    """FID between two feature sets: ‖μ₁−μ₂‖² + tr(Σ₁ + Σ₂ − 2(Σ₁Σ₂)^½),
    the trace of the root from the eigenvalues of √Σ₁·Σ₂·√Σ₁.

    Host-side float64: the D² eigendecompositions are cheap on the CPU,
    and float32 ones on near-singular covariances report a nonzero FID
    for identical feature sets."""
    f1, f2 = _f64(feats1), _f64(feats2)
    mu1, mu2 = f1.mean(axis=0), f2.mean(axis=0)
    s1, s2 = covariance(f1), covariance(f2)
    w1, v1 = np.linalg.eigh(s1)
    sqrt_s1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    wm = np.linalg.eigvalsh(sqrt_s1 @ s2 @ sqrt_s1)
    trace_sqrt = np.sum(np.sqrt(np.clip(wm, 0.0, None)))
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2.0 * trace_sqrt)


def extractor_features(images, extractor, batch: int = 256) -> np.ndarray:
    """[N, D] features (numpy) of NHWC images in [−1, 1], in chunks of
    ``batch``."""
    with f32_extraction():
        return np.concatenate([
            extractor(images[i:i + batch])[0].cpu().numpy()
            for i in range(0, len(images), batch)])


def sampler_extractor_fid(sample_fn: Callable[[int, torch.Generator],
                                               torch.Tensor],
                          num_samples: int, real_feats: np.ndarray,
                          extractor, key_seed: int = 1000,
                          batch: int = 128) -> float:
    """Extractor-FID of a sampler against precomputed real features.

    ``sample_fn(batch, generator)`` returns [batch, H, W, C] in about
    [−1, 1]; the chunk starting at sample i draws from a generator on the
    extractor's device seeded from (``key_seed``, i), as the reference
    folds i into its key. Samples are clipped to [−1, 1]."""
    chunks = []
    for i in range(0, num_samples, batch):
        x = sample_fn(batch, _generator(extractor.device, key_seed, i))
        chunks.append(torch.as_tensor(x).clamp(-1.0, 1.0))
    gen = torch.cat(chunks)[:num_samples]
    return frechet_distance(extractor_features(gen, extractor), real_feats)


def inception_score(logits, splits: int = 10):
    """(mean, std) of the Inception Score over class logits in
    ``splits`` splits; the std is the population std."""
    probs = torch.softmax(torch.as_tensor(logits).float(), dim=-1)
    n = probs.shape[0]
    split_size = max(n // splits, 1)
    scores = []
    for i in range(splits):
        part = probs[i * split_size:(i + 1) * split_size]
        if part.shape[0] == 0:
            continue
        marginal = part.mean(dim=0, keepdim=True)
        kl = (part * (torch.log(part + 1e-10)
                      - torch.log(marginal + 1e-10))).sum(dim=-1)
        scores.append(torch.exp(kl.mean()))
    scores = torch.stack(scores)
    return float(scores.mean()), float(scores.std(correction=0))


def psnr(pred, target, value_range: float = 2.0) -> torch.Tensor:
    """Mean PSNR over a batch of NHWC images ([−1, 1] ⇒ range 2)."""
    pred, target = torch.as_tensor(pred), torch.as_tensor(target)
    mse = ((pred - target) ** 2).mean(dim=(1, 2, 3))
    return (20.0 * math.log10(value_range)
            - 10.0 * torch.log10(mse + 1e-12)).mean()


def ssim(pred, target, value_range: float = 2.0, window: int = 11,
         window_type: str = "gaussian", sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM (Wang et al. 2004) over a batch of NHWC images, with the
    11×11 σ=1.5 Gaussian window (``window_type="gaussian"``) or a box
    window (``"uniform"``), each channel filtered alone with VALID
    padding."""
    pred = torch.as_tensor(pred).float()
    target = torch.as_tensor(target).float().to(pred.device)
    c1 = (0.01 * value_range) ** 2
    c2 = (0.03 * value_range) ** 2
    if window_type == "gaussian":
        r = torch.arange(window, dtype=torch.float32) - (window - 1) / 2.0
        g = torch.exp(-(r ** 2) / (2.0 * sigma ** 2))
        g = g / g.sum()
        kernel = g[:, None] * g[None, :]
    elif window_type == "uniform":
        kernel = torch.ones((window, window)) / (window * window)
    else:
        raise ValueError(f"window_type must be 'gaussian' or 'uniform', "
                         f"got {window_type!r}")
    ch = pred.shape[-1]
    kernel = kernel.to(pred.device).expand(ch, 1, window, window)

    def filt(x):
        return F.conv2d(x, kernel, groups=ch)

    p, t = pred.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2)
    mu_p, mu_t = filt(p), filt(t)
    sigma_p = filt(p * p) - mu_p ** 2
    sigma_t = filt(t * t) - mu_t ** 2
    sigma_pt = filt(p * t) - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * sigma_pt + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (sigma_p + sigma_t + c2)
    return (num / den).mean()


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------

def _images(batch) -> torch.Tensor:
    return batch["image"] if isinstance(batch, dict) else batch


class DiffusionBenchmark:
    """The evaluation protocol: features of the real set, ``n_samples``
    generated in batches of ``batch_size``, and {fid, is_mean, is_std,
    ssim, psnr} (and ``nll_bits_per_dim`` when ``metrics["nll"]``).

    SSIM and PSNR pairing (``pairing``):

    * ``"unpaired"`` (the reference's protocol): each generated batch
      against an arbitrary real batch (``i % len``), cut to the shorter
      of the two. Unconditional samples have no real counterpart, so these
      two numbers measure nothing about reconstruction.
    * ``"reconstruction"``: each real batch is noised once to
      t = max(⌊T·``recon_t_frac``⌋, 1) and the model's one-shot x̂₀ from
      its ε̂, clipped to [−1, 1], is scored against it. Needs a model with
      a noise schedule and ``eps_fn`` (ddpm, ddim).

    ``sampler`` "default" samples with the model's own
    ``generate_samples``; "dpm++", "heun" and "strided" with that sampler
    at ``sampler_steps`` (default 20), ε-prediction models only.

    Batch i's draws come from a generator on the model's device seeded
    from (``seed``, i); the reconstruction and NLL draws of real batch j
    from (``seed`` + 1, j).

    Over ranks (``scope``, a ``parallel/mesh.py::Scope`` of more than
    one): every rank of it calls :meth:`evaluate`, samples its rows of
    each generated batch (drawing the whole batch's noise) and sends them
    to rank 0, which alone reads the real set, extracts features and
    scores, from the images one process would make; the others return
    None.
    """

    def __init__(self, n_samples: int = 2000, batch_size: int = 128,
                 use_inception: bool = False, seed: int = 0,
                 metrics: Optional[Dict[str, bool]] = None,
                 pairing: str = "unpaired", recon_t_frac: float = 0.25,
                 sampler: str = "default",
                 sampler_steps: Optional[int] = None,
                 device: Union[str, torch.device, None] = None,
                 scope=None):
        if pairing not in ("unpaired", "reconstruction"):
            raise ValueError(
                f"pairing must be 'unpaired' or 'reconstruction' "
                f"(got {pairing!r})")
        if sampler not in ("default", *SAMPLERS):
            raise ValueError(
                f"sampler must be 'default', 'dpm++', 'heun' or "
                f"'strided' (got {sampler!r})")
        self.n_samples = n_samples
        self.batch_size = batch_size
        self.scope = scope
        self.extractor = (make_extractor(use_inception, seed, device=device)
                          if scope is None or scope.rank == 0 else None)
        self.seed = seed
        self.metrics = metrics or {"fid": True, "inception_score": True,
                                   "ssim": True, "psnr": True}
        self.pairing = pairing
        self.recon_t_frac = recon_t_frac
        self.sampler = sampler
        self.sampler_steps = sampler_steps

    def _make_reconstruct(self, model):
        """x → x̂₀ = (x_t − √(1−ᾱ_t)·ε̂)/√ᾱ_t at the fixed t, clipped."""
        if not (hasattr(model, "schedule") and hasattr(model, "eps_fn")):
            raise ValueError(
                "pairing='reconstruction' needs an ε-prediction model "
                "with a noise schedule (ddpm/ddim); use "
                "pairing='unpaired' for score/energy families")
        from ..models.schedules import q_sample
        t_val = max(int(model.num_timesteps * self.recon_t_frac), 1)
        eps_fn = model.eps_fn()
        ac = model.schedule.alphas_cumprod[t_val]

        @torch.no_grad()
        def reconstruct(x, generator):
            t = torch.full((x.shape[0],), t_val, dtype=torch.long,
                           device=x.device)
            noise = torch.randn(x.shape, generator=generator,
                                device=x.device, dtype=x.dtype)
            xt = q_sample(model.schedule, x, t, noise)
            x0 = (xt - torch.sqrt(1.0 - ac) * eps_fn(xt, t)) / torch.sqrt(ac)
            return x0.clamp(-1.0, 1.0)

        return reconstruct

    def _sample(self, model, bs: int, generator: torch.Generator,
                rows=None):
        kw = {} if rows is None else {"rows": rows}
        if self.sampler == "default":
            return model.generate_samples(bs, generator, **kw)
        method = SAMPLERS[self.sampler]
        if not hasattr(model, method):
            raise ValueError(
                f"benchmark.sampler {self.sampler!r} needs an "
                "ε-prediction model (ddpm/ddim); use "
                "'default' for score/energy families")
        return getattr(model, method)(bs, num_steps=self.sampler_steps or 20,
                                      generator=generator, **kw)

    def generated(self, model):
        """The generated batches in order: batch i from the generator of
        (seed, i), sampled over the scope's ranks and gathered on rank 0
        (yielded there only)."""
        from ..scripts.generate import rank_samples
        remaining, i = self.n_samples, 0
        while remaining > 0:
            bs = min(self.batch_size, remaining)
            gen = _generator(model.device, self.seed, i)
            if self.scope is None or self.scope.world == 1:
                yield self._sample(model, bs, gen)
            else:
                parts = self.scope.gather(rank_samples(
                    lambda rows: self._sample(model, bs, gen, rows),
                    self.scope.rows(bs), model))
                if parts is not None:
                    yield torch.from_numpy(np.concatenate(parts)).to(
                        model.device)
            remaining -= bs
            i += 1

    def evaluate(self, model, test_loader: Iterable,
                 sample_dir: Optional[str] = None
                 ) -> Optional[Dict[str, float]]:
        """Run the protocol with ``model``'s current weights; with
        ``sample_dir``, save each generated batch as a PNG grid there.
        Over ranks, the results on rank 0 and None on the others."""
        if self.extractor is None:   # a rank that only samples
            for _ in self.generated(model):
                pass
            return None
        want_ssim = self.metrics.get("ssim", True)
        want_psnr = self.metrics.get("psnr", True)
        want_nll = (self.metrics.get("nll", False)
                    and hasattr(model, "nll_bits_per_dim"))
        recon = None
        if self.pairing == "reconstruction" and (want_ssim or want_psnr):
            recon = self._make_reconstruct(model)
        device = model.device

        real_feats: List[np.ndarray] = []
        real_batches: List[torch.Tensor] = []
        ssim_vals, psnr_vals, nll_vals = [], [], []
        gens: List[torch.Generator] = []
        for j, batch in enumerate(test_loader):
            x = _images(batch).to(device, torch.float32)
            with f32_extraction():
                real_feats.append(self.extractor(x)[0].cpu().numpy())
            real_batches.append(x)
            gens.append(_generator(device, self.seed + 1, j))
            if recon is not None:
                x0 = recon(x, gens[j])
                if want_ssim:
                    ssim_vals.append(float(ssim(x0, x)))
                if want_psnr:
                    psnr_vals.append(float(psnr(x0, x)))
        real = np.concatenate(real_feats) if real_feats else None

        fake_feats, fake_logits = [], []
        for i, samples in enumerate(self.generated(model)):
            bs = samples.shape[0]
            if sample_dir is not None:
                from .images import save_image
                save_image(samples.cpu().numpy(),
                           f"{sample_dir}/batch_{i:04d}.png")
            with f32_extraction():
                feats, logits = self.extractor(samples)
            fake_feats.append(feats.cpu().numpy())
            fake_logits.append(logits)
            if real_batches and recon is None:
                ref = real_batches[i % len(real_batches)]
                n = min(len(ref), bs)
                if want_ssim:
                    ssim_vals.append(float(ssim(samples[:n], ref[:n])))
                if want_psnr:
                    psnr_vals.append(float(psnr(samples[:n], ref[:n])))
        # After the sampling, which the other ranks wait on; real batch j
        # goes on with the generator its reconstruction drew from.
        if want_nll:
            for x, gen in zip(real_batches, gens):
                nll_vals.extend(model.nll_bits_per_dim(x, gen).tolist())

        results: Dict[str, float] = {}
        if self.metrics.get("fid", True) and real is not None:
            results["fid"] = frechet_distance(real,
                                              np.concatenate(fake_feats))
        if self.metrics.get("inception_score", True):
            results["is_mean"], results["is_std"] = inception_score(
                torch.cat(fake_logits))
        if ssim_vals:
            results["ssim"] = float(np.mean(ssim_vals))
        if psnr_vals:
            results["psnr"] = float(np.mean(psnr_vals))
        if nll_vals:
            results["nll_bits_per_dim"] = float(np.mean(nll_vals))
        return results
