"""DDIM — Denoising Diffusion Implicit Models (Song et al. 2021), the
counterpart of the reference's ``models/ddim.py``: trains exactly as DDPM
and samples in ``ddim_sampling_steps`` (default 50) deterministic (η = 0)
or stochastic (η > 0) steps.

* Timesteps by ``uniform`` spacing (stride T//S) or ``quad`` spacing.
  With S not dividing T, uniform spacing has more than S entries and the
  sampler visits only the first S positions, as the reference does.
* Buffers are indexed by step position, not by timestep value.
* The sampler state and the DDIM update stay f32; the S steps are a
  Python loop over the UNet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from .base import Draw, Noise, Rows, cut_rows
from .ddpm import DDPM
from .schedules import ddim_step, make_ddim_params


class DDIM(DDPM):
    """DDIM model family (training inherited from DDPM).

    Extra config keys: ddim_sampling_steps (clamped to at most T),
    ddim_discretize_method (uniform | quad), eta."""

    def __init__(self, config: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0, trainable: bool = False):
        super().__init__(config, device, seed=seed, trainable=trainable)
        cfg = self.config
        self.ddim_sampling_steps = min(
            int(cfg.get("ddim_sampling_steps", 50)), self.num_timesteps)
        self.ddim_discretize = cfg.get("ddim_discretize_method", "uniform")
        self.eta = float(cfg.get("eta", 0.0))
        self.ddim_params = make_ddim_params(
            self.schedule, self.ddim_sampling_steps, self.ddim_discretize,
            self.eta)
        self._ddim_ts = self.ddim_params.timesteps.tolist()

    def _ddim_scan(self, x: torch.Tensor, i_hi: int, i_lo: int, draw: Draw,
                   eps_fn=None) -> torch.Tensor:
        """DDIM steps at positions i_hi−1 down to i_lo; a noise draw a
        step only when η > 0."""
        b = x.shape[0]
        eps_fn = eps_fn if eps_fn is not None else self.eps_fn()
        for i in range(i_hi - 1, i_lo - 1, -1):
            eps = eps_fn(x, self._t(b, self._ddim_ts[i]))
            noise = draw() if self.eta > 0 else None
            x = ddim_step(self.ddim_params, x, i, eps, noise, self.eta)
        return x

    @torch.inference_mode()
    def generate_samples(self, batch_size: int,
                         generator: Optional[torch.Generator] = None,
                         noise: Noise = None,
                         rows: Rows = None) -> torch.Tensor:
        """S-step DDIM sampler. Draws: x_T, then one a step when η > 0;
        ``rows`` as DDPM's."""
        x, draw, _ = self._start(batch_size, generator, noise, rows)
        return self._ddim_scan(x, self.ddim_sampling_steps, 0, draw)

    @torch.inference_mode()
    def generate_samples_cfg(self, batch_size: int, labels: torch.Tensor,
                             guidance_scale: float = 3.0,
                             generator: Optional[torch.Generator] = None,
                             noise: Noise = None,
                             rows: Rows = None) -> torch.Tensor:
        """S-step DDIM sampling with classifier-free guidance."""
        x, draw, keep = self._start(batch_size, generator, noise, rows)
        return self._ddim_scan(x, self.ddim_sampling_steps, 0, draw,
                               self.eps_fn(cut_rows(labels, keep),
                                           guidance_scale))

    @torch.inference_mode()
    def generate_samples_with_intermediates(
            self, batch_size: int,
            generator: Optional[torch.Generator] = None,
            save_interval: int = 2) -> List[torch.Tensor]:
        """The DDIM sampler with frames: x_T, then x after each position
        i with i % save_interval == 0 (i = 0 always included)."""
        draw = self._drawer(self.sample_shape(batch_size), generator, None)
        x = self._init_noise(batch_size, draw)
        frames = [x]
        save_is = sorted(set(range(0, self.ddim_sampling_steps,
                                   save_interval)) | {0}, reverse=True)
        i_hi = self.ddim_sampling_steps
        for i_save in save_is:
            x = self._ddim_scan(x, i_hi, i_save, draw)
            frames.append(x)
            i_hi = i_save
        return frames
