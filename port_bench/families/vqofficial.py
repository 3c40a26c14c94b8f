"""The VQ_Official prior over the stage-1 VQGAN's codes (the port's
``models/vq_diffusion_composite.VQDiffusionComposite`` under
``diffusion_type: VQ_Official``): the discrete mask-and-replace diffusion
of ``diffusion/discrete.DiscreteDiffusion`` over K = 1024 classes at each
of the N = 256 positions, its denoiser the ShuffleNet U-Net on the
[B, K, N, 1] log-probability image.

Serving runs the whole chain through ``composite.sample``: a dense first
step, then each structured step through the BN-folded U-Net of kernels K1
and K2 and the posterior-and-sample kernel B6. The benchmark draws the
chain's starting uniforms and every step's Gumbel noise from the seed, the
request and the step, each step's when the chain reads it. ``serve_sample``
returns the filmstrip, the indices after every step, and ``serve_decode``
decodes its last frame. The check judges the timed chain step by step
against :mod:`..reference.discrete`, :mod:`..reference.shuffle_unet` and
:mod:`..reference.vqgan`. The family serves only: it has no train cell.
"""

from __future__ import annotations

import random
from typing import List

import torch

from .. import yardstick
from ..reference import discrete as rd
from ..reference import precision
from ..weights import derive, draw, generator, unet_rule, vqgan_rule
from .common import Reading, dataset_tree, relative_image_error
from .gaussian3d import _reference       # the same VQGAN and U-Net, by the same keys

MODEL = "vqdiffusion"


def port_config(cfg: dict):
    """The port's configuration tree. The port's VQ_Official U-Net has fixed
    widths (base 64, mults 1, 2, 4, 8), which the configuration states."""
    from vq_vae_gan_diffusion_torch.config import config_from_dict

    return config_from_dict({
        "architecture": {"model_name": MODEL, "vqvae": cfg["vqvae"], MODEL: cfg[MODEL]},
        "dataset": dataset_tree(cfg, MODEL)})


def _sizes(cfg: dict):
    """(steps, K classes, N positions)."""
    return cfg[MODEL]["sampling_steps"], cfg["vqvae"]["num_codebook_vectors"], \
        cfg["vqvae"]["latent_size"] ** 2


def _composite(cfg: dict, seed: int, device):
    from vq_vae_gan_diffusion_torch.models.vq_diffusion_composite import VQDiffusionComposite

    with torch.device(device):
        comp = VQDiffusionComposite(port_config(cfg))
    comp = comp.to(device)
    draw(dict(comp.vqvae.named_parameters()), vqgan_rule, seed, "vqgan")
    draw(dict(comp.unet.named_parameters()), unet_rule, seed, "unet")
    comp.vqvae.eval().requires_grad_(False)
    return comp.eval()


def _uniform(cfg: dict, seed: int, i, n: int, device, *tags) -> torch.Tensor:
    _, k, seq = _sizes(cfg)
    g = generator(device, seed, "request", i, *tags)
    return torch.rand((n, seq, k), generator=g, device=device)


class StepNoise:
    """Request ``i``'s Gumbel noise [n, N, K] of step j, drawn from the seed,
    the request and the step when the chain reads it: drawn up front, the
    1000 steps' noise would take 4.2 GB at 4 images."""

    def __init__(self, cfg: dict, seed: int, i, n: int, device):
        self.cfg, self.seed, self.i, self.n, self.device = cfg, seed, i, n, device

    def __getitem__(self, j: int) -> torch.Tensor:
        return rd.gumbel(_uniform(self.cfg, self.seed, self.i, self.n, self.device, "step", j))


def _noise(cfg: dict, seed: int, i, n: int, device) -> dict:
    """Request i's starting uniforms and step noise, as ``sample`` takes them."""
    return {"init_uniform": _uniform(cfg, seed, i, n, device, "init"),
            "step_gumbel": StepNoise(cfg, seed, i, n, device)}


# -- serving ---------------------------------------------------------------

def serve_setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    from vq_vae_gan_diffusion_torch.utils.device import resolve_device

    device = resolve_device(str(device))
    return {"cfg": cfg, "comp": _composite(cfg, seed, device), "seed": seed, "device": device}


def serve_inputs(side: dict, i: int, greedy: bool) -> dict:
    """The process has no greedy mode: ``greedy`` is ignored."""
    return {"i": i}


def serve_sample(side: dict, n: int, inputs: dict) -> torch.Tensor:
    """The filmstrip [n, steps, N]: the indices after each reverse step."""
    noise = _noise(side["cfg"], side["seed"], inputs["i"], n, side["device"])
    return side["comp"].sample(n, return_all_timesteps=True, **noise)[1]


def serve_decode(side: dict, film: torch.Tensor) -> torch.Tensor:
    return side["comp"].z_to_image(film[:, -1])


@torch.no_grad()
def serve_warmup(side: dict, n: int) -> None:
    """A chain of three steps at the request's batch (the dense step, two
    through B6, every unit shape of the U-Net) and the decode: a whole chain
    would take as long as a request."""
    prior = side["comp"].prior
    steps = prior.sampling_timesteps
    prior.sampling_timesteps = 3
    try:
        film = serve_sample(side, n, {"i": "warm-up"})
    finally:
        prior.sampling_timesteps = steps
    serve_decode(side, film)


def steps_per_request(cfg: dict) -> int:
    return cfg[MODEL]["sampling_steps"]


def request_flops(cfg: dict, n: int) -> int:
    steps, k, seq = _sizes(cfg)
    return steps * yardstick.unet_flops(yardstick.unet_sizes(cfg), n, k, seq) + \
        yardstick.decoder_flops(cfg["vqvae"], cfg["img_channels"], n)


def checked_steps(cfg: dict, seed: int, i: int) -> List[int]:
    """The steps of request i that the check judges: the first (dense), the
    configuration's ``checked_steps`` drawn from the seed among the others,
    and the last."""
    steps = steps_per_request(cfg)
    inner = range(1, steps - 1)
    drawn = random.Random(derive(seed, "checked steps", i)).sample(
        inner, min(cfg["checked_steps"], len(inner)))
    return [0, *sorted(drawn), steps - 1]


@torch.no_grad()
def serve_check(cfg: dict, seed: int, kept: List[dict], device, control: bool = False
                ) -> List[Reading]:
    """For each kept request with its images, at each of its
    :func:`checked_steps`, from the state the timed chain held before the
    step (the chain's starting log u, or the indices of the filmstrip's
    frame before it) and the step's noise drawn again:

    - ``logit_gap``: the widest |log p(x̂_0 | x_t)| difference, the
      program's (the port's ``predict_start`` on the same state, at the
      request's batch, through K1 and K2) against the reference's;
    - ``pick_gap``: the widest gap by which the program's pick x_{t-1} (the
      next frame) scores below the best pick under the reference's
      log-posterior plus the noise;
    - ``image_err``: the decoder's images of the served indices against the
      reference VQGAN's.

    The control puts the reference in TF32 in the program's place: its
    x̂_0, its pick, its decode."""
    if not any(r["images"] is not None for r in kept):
        return [("logit_gap", None), ("pick_gap", None), ("image_err", None)]
    prior = _composite(cfg, seed, device).bind()       # the program, drawn again from the seed
    vq, unet = _reference(cfg, seed, device)
    unet.eval()
    steps, k, _ = _sizes(cfg)
    sched = {name: v.to(device) for name, v in rd.schedule(cfg[MODEL]["diffusion_steps"],
                                                            k).items()}
    logit, gap, err = 0.0, 0.0, 0.0
    for rec in kept:
        if rec["images"] is None:
            continue
        film = rec["codes"].to(device)
        n = film.shape[0]
        noise = _noise(cfg, seed, rec["i"], n, device)
        for s in checked_steps(cfg, seed, rec["i"]):
            t = torch.full((n,), steps - 1 - s, dtype=torch.long, device=device)
            log_x = noise["init_uniform"].log() if s == 0 else None
            ref_x = (log_x.transpose(1, 2) if s == 0
                     else rd.index_to_log_onehot(film[:, s - 1], k))
            g = noise["step_gumbel"][s].transpose(1, 2)
            with precision(False):
                ref_x0 = rd.predict_start(unet, ref_x, t)
                score = rd.q_posterior(sched, ref_x0, ref_x, t) + g
            if control:
                with precision(True):
                    prog_x0 = rd.predict_start(unet, ref_x, t)
                    chosen = rd.pick(rd.q_posterior(sched, prog_x0, ref_x, t), g)
            else:
                prog = (prior.predict_start(log_x, t) if s == 0
                        else prior.predict_start_idx(film[:, s - 1], t))
                prog_x0, chosen = prog.transpose(1, 2), film[:, s]
            logit = max(logit, float((prog_x0 - ref_x0).abs().max()))
            below = score.max(1).values - score.gather(1, chosen[:, None])[:, 0]
            gap = max(gap, float(below.max()))
        with precision(False):
            ref_img = vq.decode_indices(film[:, -1])
        if control:
            with precision(True):
                img = vq.decode_indices(film[:, -1])
        else:
            img = rec["images"].to(device)
        err = max(err, relative_image_error(img, ref_img))
    return [("logit_gap", logit), ("pick_gap", gap), ("image_err", err)]
