"""Continuous Gaussian diffusion over token sequences (PyTorch counterpart of
the JAX ``diffusion/gaussian2d.py``, "GaussianDiffusion2D").

- the cosine beta schedule;
- index -> continuous maps: a smoothed one-hot (smoothing 0.1) or a fixed
  uniform lookup table [K, gaussian_dim]; back by argmax, or by the nearest
  table row (an explicit L2 argmin in float32);
- ``distribute_dim`` -1 keeps the state [B, N, D]; 1 swaps it to [B, D, N];
  the denoiser takes the state as [B, C, L], axis 1 its channels;
- ``loss``: the noise MSE, a mean per sample and then over the batch, with
  the self-conditioning coin (the extra forward on half the steps);
- sampling: DDIM (``sample`` always takes it) or the DDPM loop; for
  ``diffusion_type`` ``vqdiffusion`` the chain starts from the continuous
  embedding of random indices and ends in indices; for
  ``gaussiandiffusion2d`` (raw sequences) it starts from the caller's
  ``xt``;
- ``interpolate``: q-sample two inputs, mix them, denoise from t.

The lookup table: the JAX process draws it on every construction as
``jax.random.uniform(PRNGKey(0), (K, gaussian_dim))``, and no checkpoint
holds it. :func:`jax_uniform` reproduces that draw bit for bit without jax
(threefry2x32 in the bit layout of ``jax_threefry_partitionable``, the
default since JAX 0.5), so a JAX-trained prior's U-Net is served with its
own table.

Noise comes from an explicit ``torch.Generator`` on the state's device, or
is injected: ``t``, ``noise`` and ``use_sc`` for the loss; ``init_indices``
(or the caller's ``xt``) and ``step_noise`` for the samplers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .gaussian import (ModelFn, _step_noise, ddim_sample, make_schedule, model_predictions,
                       q_posterior, q_sample)
from .gaussian3d import _draw_t_noise

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds) of counters (x0, x1)."""
    def rotl(v, r):
        return (v << np.uint32(r)) | (v >> np.uint32(32 - r))

    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def jax_uniform(seed: int, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(seed), shape)`` (float32 in
    [0, 1)), bit for bit: element i's bits are the xor of threefry2x32's two
    words on the counter (i >> 32, i & 0xffffffff), their top 23 bits the
    mantissa of a float in [1, 2), less one."""
    n = int(np.prod(shape))
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    key = ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)
    b0, b1 = _threefry2x32(key, hi, lo)
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats).reshape(tuple(shape))


class GaussianDiffusion2DConfig(NamedTuple):
    seq_length: int = 256
    timesteps: int = 1000
    sampling_timesteps: int = 1000
    objective: str = "pred_noise"
    ddim_sampling_eta: float = 0.0
    vocab_size: int = 1024
    distribute_dim: int = -1
    gaussian_dim: int = 512
    indices_to_dist_fn: str = "lookup_table"
    diffusion_type: str = "vqdiffusion"   # or 'gaussiandiffusion2d' (raw sequences)
    self_condition: bool = False


class GaussianDiffusion2D(nn.Module):
    """The process around ``model_fn(x [B, C, L], self_cond, t)``; the lookup
    table is a buffer (not saved: it is drawn again, as in JAX)."""

    def __init__(self, cfg: GaussianDiffusion2DConfig, model_fn: Optional[ModelFn] = None):
        super().__init__()
        self.cfg = cfg
        self.model_fn = model_fn
        self.sched = make_schedule(cfg.timesteps, "cosine")
        table = (torch.from_numpy(jax_uniform(0, (cfg.vocab_size, cfg.gaussian_dim)))
                 if cfg.diffusion_type == "vqdiffusion" else None)
        self.register_buffer("lookup_table", table, persistent=False)

    # -- index <-> continuous maps ---------------------------------------------------
    def _swap(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2) if self.cfg.distribute_dim == 1 else x

    def indices_to_smooth_onehot(self, x0: torch.Tensor, smoothing: float = 0.1):
        onehot = self._swap(nn.functional.one_hot(x0.long(), self.cfg.vocab_size).float())
        return onehot * (1 - smoothing) + smoothing / self.cfg.vocab_size

    def onehot_to_indices(self, onehot: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self._swap(onehot), dim=-1)

    def indices_to_gaussian(self, indices: torch.Tensor) -> torch.Tensor:
        return self._swap(self.lookup_table[indices.long()])

    def gaussian_to_indices(self, gaussian: torch.Tensor) -> torch.Tensor:
        """The nearest table row by L2, as the JAX explicit expansion."""
        gaussian = self._swap(gaussian)
        b, n, d = gaussian.shape
        flat = gaussian.reshape(-1, d).float()
        table = self.lookup_table
        with torch.autocast(flat.device.type, enabled=False):
            dist = (torch.sum(flat ** 2, -1, keepdim=True) + torch.sum(table ** 2, -1)
                    - 2 * flat @ table.T)
        return torch.argmin(dist, dim=-1).reshape(b, n)

    def to_continuous(self, indices: torch.Tensor) -> torch.Tensor:
        if self.cfg.indices_to_dist_fn == "lookup_table":
            return self.indices_to_gaussian(indices)
        return self.indices_to_smooth_onehot(indices)

    def to_indices(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.indices_to_dist_fn == "lookup_table":
            return self.gaussian_to_indices(x)
        return self.onehot_to_indices(x)

    # -- training --------------------------------------------------------------------
    def loss(self, x0_indices_or_seq: torch.Tensor, generator: Optional[torch.Generator] = None,
             *, t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             use_sc: Optional[bool] = None) -> torch.Tensor:
        """The noise MSE of indices [B, N] (``vqdiffusion``) or a raw
        sequence [B, C, L]. ``t``, ``noise`` and the self-conditioning coin
        ``use_sc`` come from ``generator`` unless given."""
        cfg = self.cfg
        x0 = (self.to_continuous(x0_indices_or_seq) if cfg.diffusion_type == "vqdiffusion"
              else x0_indices_or_seq)
        t, noise = _draw_t_noise(x0, cfg.timesteps, generator, t, noise)
        x_t = q_sample(self.sched, x0, t, noise)
        x_self_cond = None
        if cfg.self_condition:
            if use_sc is None:
                use_sc = bool(torch.rand((), generator=generator,
                                         device=x0.device if generator is None
                                         else generator.device) < 0.5)
            if use_sc:
                with torch.no_grad():
                    x_self_cond = model_predictions(self.sched, self.model_fn, x_t, None, t,
                                                    cfg.objective)[1]
            else:
                x_self_cond = torch.zeros_like(x_t)
        out = self.model_fn(x_t, x_self_cond, t)
        per = torch.mean((out.to(noise.dtype) - noise) ** 2, dim=tuple(range(1, out.dim())))
        return torch.mean(per)

    # -- sampling --------------------------------------------------------------------
    def _chain_start(self, batch_size: int, xt: Optional[torch.Tensor],
                     generator: Optional[torch.Generator], device,
                     init_indices: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        if cfg.diffusion_type != "vqdiffusion":
            if xt is None:
                raise ValueError("raw-sequence mode needs an initial xt")
            return xt
        if init_indices is None:
            if generator is not None:
                device = generator.device
            init_indices = torch.randint(0, cfg.vocab_size, (batch_size, cfg.seq_length),
                                         generator=generator, device=device)
        return self.to_continuous(init_indices.to(self.lookup_table.device))

    def _result(self, img: torch.Tensor) -> torch.Tensor:
        return self.to_indices(img) if self.cfg.diffusion_type == "vqdiffusion" else img

    @torch.no_grad()
    def ddim_sample(self, batch_size: int = 16, xt: Optional[torch.Tensor] = None,
                    clip_denoised: bool = True, *, generator: Optional[torch.Generator] = None,
                    device=None, init_indices: Optional[torch.Tensor] = None,
                    step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """The DDIM chain over ``sampling_timesteps``; indices [B, N] for
        ``vqdiffusion``, else the state."""
        cfg = self.cfg
        img = self._chain_start(batch_size, xt, generator, device, init_indices)
        img = ddim_sample(self.sched, self.model_fn, img, None, cfg.ddim_sampling_eta,
                          cfg.sampling_timesteps, cfg.objective, clip_denoised,
                          generator=generator, step_noise=step_noise)
        return self._result(img)

    @torch.no_grad()
    def p_sample_loop(self, batch_size: int = 16, xt: Optional[torch.Tensor] = None,
                      clip_denoised: bool = True, *,
                      generator: Optional[torch.Generator] = None, device=None,
                      init_indices: Optional[torch.Tensor] = None,
                      step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """The DDPM loop, t = T-1 .. 0, through the posterior mean of the
        predicted x0 (no noise at t = 0)."""
        cfg = self.cfg
        img = self._chain_start(batch_size, xt, generator, device, init_indices)
        for i, t in enumerate(range(cfg.timesteps - 1, -1, -1)):
            img = self._posterior_step(img, t, _step_noise(i, img, generator, step_noise),
                                       clip_denoised)
        return self._result(img)

    def _posterior_step(self, x: torch.Tensor, t: int, z: torch.Tensor,
                        clip: bool) -> torch.Tensor:
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        _, x_start = model_predictions(self.sched, self.model_fn, x, None, tb,
                                       self.cfg.objective, clip_x_start=clip)
        mean, _, logvar = q_posterior(self.sched, x_start, x, tb)
        return mean + torch.exp(0.5 * logvar) * z if t > 0 else mean

    def sample(self, batch_size: int = 16, xt: Optional[torch.Tensor] = None,
               **noise) -> torch.Tensor:
        """Always the DDIM chain, as the reference's ``sample``."""
        return self.ddim_sample(batch_size, xt, **noise)

    @torch.no_grad()
    def interpolate(self, x1: torch.Tensor, x2: torch.Tensor, t: Optional[int] = None,
                    lam: float = 0.5, *, generator: Optional[torch.Generator] = None,
                    noise1: Optional[torch.Tensor] = None, noise2: Optional[torch.Tensor] = None,
                    step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """q-sample x1 and x2 to t (default T-1), mix them (1 - lam : lam) and
        denoise from t - 1 down to 0 with clipped x0."""
        t = self.cfg.timesteps - 1 if t is None else t
        tb = torch.full((x1.shape[0],), t, dtype=torch.long, device=x1.device)
        noise1 = _step_noise(0, x1, generator, None if noise1 is None else [noise1])
        noise2 = _step_noise(0, x2, generator, None if noise2 is None else [noise2])
        img = ((1 - lam) * q_sample(self.sched, x1, tb, noise1)
               + lam * q_sample(self.sched, x2, tb, noise2))
        for i, step in enumerate(range(t - 1, -1, -1)):
            img = self._posterior_step(img, step, _step_noise(i, img, generator, step_noise),
                                       True)
        return img
