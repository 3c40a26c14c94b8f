"""The gaussian3d prior over the stage-1 VQGAN's codes (the port's
``models/vq_diffusion_composite.VQDiffusionComposite``): a ShuffleNet
U-Net denoises the [B, N, D, 1] embeddings of the codes.

Serving runs the whole DDPM chain through ``composite.sample`` (the
BN-folded U-Net of kernels K1 and K2 under ``fused_sampler``) with the
starting state and every step's noise drawn by the benchmark, then
decodes; training runs ``VQDiffusionWorker.train_step`` with the step's t
and noise drawn by the benchmark. The reference is :mod:`..reference.vqgan`,
:mod:`..reference.shuffle_unet`, :mod:`..reference.ddpm` and
:mod:`..reference.optim`.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import torch

from .. import yardstick
from ..reference import precision
from ..reference.ddpm import cosine_schedule, cosine_scores, ddpm_chain, lookup_table, noise_mse
from ..reference.optim import AdamW as RefAdamW, ema_update, onecycle
from ..reference.shuffle_unet import ShuffleUNet as RefUNet
from ..reference.vqgan import VQGAN as RefVQGAN
from ..weights import draw, generator, unet_rule, vqgan_rule
from .common import Reading, dataset_tree, images, relative_image_error, run_dir

MODEL = "vqdiffusion"


def port_config(cfg: dict):
    """The port's configuration tree, the U-Net's widths handed over as the
    benchmark's configuration states them."""
    from vq_vae_gan_diffusion_torch.config import config_from_dict

    u = yardstick.unet_sizes(cfg)
    prior = dict(cfg[MODEL], base_dim=u["base_dim"], unet_dim_mults=u["dim_mults"])
    return config_from_dict({
        "architecture": {"model_name": MODEL, "vqvae": cfg["vqvae"], MODEL: prior},
        "dataset": dataset_tree(cfg, MODEL),
        "trainer": {"num_epochs": cfg["trainer"]["num_epochs"], MODEL: cfg["trainer"][MODEL]}})


def _state_shape(cfg: dict, n: int):
    return (n, cfg["vqvae"]["latent_size"] ** 2, cfg[MODEL]["gaussian_dim"], 1)


def _composite(cfg: dict, seed: int, device):
    from vq_vae_gan_diffusion_torch.models.vq_diffusion_composite import VQDiffusionComposite

    with torch.device(device):
        comp = VQDiffusionComposite(port_config(cfg))
    comp = comp.to(device)
    draw(dict(comp.vqvae.named_parameters()), vqgan_rule, seed, "vqgan")
    draw(dict(comp.unet.named_parameters()), unet_rule, seed, "unet")
    comp.vqvae.eval().requires_grad_(False)
    return comp


def _reference(cfg: dict, seed: int, device):
    vq = RefVQGAN.from_sizes(cfg["vqvae"], cfg["img_size"], cfg["img_channels"]).to(device)
    u = yardstick.unet_sizes(cfg)
    unet = RefUNet(cfg[MODEL]["diffusion_steps"], u["time_embedding_dim"], u["in_channels"],
                   u["out_channels"], u["base_dim"], u["dim_mults"]).to(device)
    draw(dict(vq.named_parameters()), vqgan_rule, seed, "vqgan")
    draw(dict(unet.named_parameters()), unet_rule, seed, "unet")
    return vq.eval().requires_grad_(False), unet


# -- serving ---------------------------------------------------------------

def serve_setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    from vq_vae_gan_diffusion_torch.utils.device import resolve_device

    device = resolve_device(str(device))
    return {"cfg": cfg, "comp": _composite(cfg, seed, device).eval(), "seed": seed,
            "device": device}


def _noise(cfg: dict, seed: int, i: int, n: int, device):
    """Request i's starting state and the noise of each reverse step."""
    g = generator(device, seed, "request", i)
    shape = _state_shape(cfg, n)
    x_T = torch.randn(shape, generator=g, device=device)
    return x_T, torch.randn((cfg[MODEL]["sampling_steps"], *shape), generator=g, device=device)


def serve_inputs(side: dict, i: int, greedy: bool) -> dict:
    return {"i": i}


def serve_sample(side: dict, n: int, inputs: dict) -> torch.Tensor:
    x_T, noise = _noise(side["cfg"], side["seed"], inputs["i"], n, side["device"])
    return side["comp"].sample(n, x_T=x_T, step_noise=noise)


def serve_decode(side: dict, codes: torch.Tensor) -> torch.Tensor:
    return side["comp"].z_to_image(codes)


@torch.no_grad()
def serve_warmup(side: dict, n: int) -> None:
    """Three reverse steps' U-Net forwards through every unit shape, the
    read-out and the decode, at the request's batch: a whole chain would
    take as long as a request."""
    comp = side["comp"]
    prior = comp.bind()
    x = torch.randn(_state_shape(side["cfg"], n), device=side["device"])
    steps = side["cfg"][MODEL]["diffusion_steps"]
    for t in (steps - 1, steps // 2, 0):
        prior.diffusion.model_fn(x, None, torch.full((n,), t, device=x.device))
    serve_decode(side, prior.gaussian_to_indices(x))


def steps_per_request(cfg: dict) -> int:
    return cfg[MODEL]["sampling_steps"]


def request_flops(cfg: dict, n: int) -> int:
    _, seq, d, _ = _state_shape(cfg, n)
    readout = 2 * n * seq * d * cfg["vqvae"]["num_codebook_vectors"]
    forward = yardstick.unet_flops(yardstick.unet_sizes(cfg), n, seq, d)
    return steps_per_request(cfg) * forward + readout + \
        yardstick.decoder_flops(cfg["vqvae"], cfg["img_channels"], n)


@torch.no_grad()
def serve_check(cfg: dict, seed: int, kept: List[dict], device, control: bool = False
                ) -> List[Reading]:
    """For each kept request with its images (the chain is long: a sample
    of one request, drawn from the seed), the reference chain from the same starting
    state and step noise: the widest gap by which the cosine similarity of
    a served index lies below the best index's for the reference's final
    state (the control: the index that the chain in TF32 reads out); and
    the decoder's images of the served indices against the reference's."""
    if not any(r["images"] is not None for r in kept):
        return [("index_gap", None), ("image_err", None)]     # nothing served to judge
    vq, unet = _reference(cfg, seed, device)
    unet.eval()
    sched = cosine_schedule(cfg[MODEL]["diffusion_steps"])
    table = lookup_table(cfg[MODEL]["gaussian_dim"], cfg["vqvae"]["num_codebook_vectors"]
                         ).to(device)
    gap, err = 0.0, 0.0
    for rec in kept:
        if rec["images"] is None:
            continue
        codes = rec["codes"].to(device)
        x_T, noise = _noise(cfg, seed, rec["i"], codes.shape[0], device)
        with precision(False):
            scores = cosine_scores(ddpm_chain(unet, sched, x_T, noise), table)
            ref_img = vq.decode_indices(codes)
        if control:
            with precision(True):
                pick = cosine_scores(ddpm_chain(unet, sched, x_T, noise), table).argmax(-1)
                img = vq.decode_indices(codes)
        else:
            pick, img = codes, rec["images"].to(device)
        del noise
        best = scores.max(-1).values
        gap = max(gap, float((best - scores.gather(-1, pick[..., None])[..., 0]).max()))
        err = max(err, relative_image_error(img, ref_img))
    return [("index_gap", gap), ("image_err", err)]


# -- training --------------------------------------------------------------

def train_setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The worker and its state as ``VQDiffusionWorker.init_state`` builds
    it, with the weights drawn on the device: the frozen VQGAN, the U-Net,
    its EMA copy and AdamW under the OneCycle schedule."""
    from vq_vae_gan_diffusion_torch.train.vq_diffusion_worker import VQDiffusionWorker

    worker = VQDiffusionWorker(port_config(cfg), run_dir(), seed=seed, device=str(device),
                               num_iters_per_epoch=cfg["trainer"]["iters_per_epoch"])
    comp = _composite(cfg, seed, worker.device)
    worker.composite = comp
    worker.state = worker._new_state(comp.unet)
    return {"cfg": cfg, "worker": worker, "seed": seed, "device": worker.device,
            "batch": traffic["batch"]}


def _feed(cfg: dict, seed: int, i: int, b: int, device) -> Dict[str, torch.Tensor]:
    g = generator(device, seed, "draws", i)
    t = torch.randint(0, cfg[MODEL]["diffusion_steps"], (b,), generator=g, device=device)
    noise = torch.randn(_state_shape(cfg, b), generator=g, device=device)
    return {"x": images(cfg, b, device, seed, "train", i), "t": t, "noise": noise}


def train_step(side: dict, i: int) -> torch.Tensor:
    f = _feed(side["cfg"], side["seed"], i, side["batch"], side["device"])
    w = side["worker"]
    w.state, metrics = w.train_step(w.state, f["x"], t=f["t"], noise=f["noise"])
    return metrics["noise_mse"]


def leaves(side: dict) -> Dict[str, torch.Tensor]:
    return dict(side["worker"].state.unet.named_parameters())


def ema_leaves(side: dict) -> Dict[str, torch.Tensor]:
    return dict(side["worker"].state.ema.named_parameters())


def _schedule(cfg: dict):
    tr = cfg["trainer"]
    return max(tr["num_epochs"] * tr["iters_per_epoch"], 10), tr[MODEL]["learning_rate"]


def first_gradient(side: dict, p: torch.Tensor) -> torch.Tensor:
    """The first step's gradient as AdamW got it: (1 - beta1) g is its first
    moment after one step, beta1 being the OneCycle's at update 0."""
    opt = side["worker"].state.opt
    opt = getattr(opt, "opt", opt)
    if "exp_avg" not in opt.state.get(p, {}):      # the step never reached the optimizer
        return torch.zeros_like(p)
    return opt.state[p]["exp_avg"] / (1 - onecycle(*_schedule(side["cfg"]), 0)[1])


def step_flops(cfg: dict, b: int) -> int:
    _, seq, d, _ = _state_shape(cfg, b)
    return yardstick.encoder_flops(cfg["vqvae"], cfg["img_size"], cfg["img_channels"], b) + \
        3 * yardstick.unet_flops(yardstick.unet_sizes(cfg), b, seq, d)


def ema_decay(cfg: dict) -> float:
    tr = cfg["trainer"]
    alpha = (1 - tr[MODEL]["model_ema_decay"]) * cfg["batch_size"] * \
        tr[MODEL]["model_ema_steps"] / tr["num_epochs"]
    return 1 - min(1.0, alpha)


def reference_train(cfg: dict, traffic: dict, seed: int, device, steps: int,
                    control: bool = False) -> dict:
    """The reference's first ``steps`` steps on the same images, t and noise:
    the noise MSEs, the first gradient's norm, and the U-Net's and the
    EMA's change after the steps, by leaf."""
    vq, unet = _reference(cfg, seed, device)
    unet.train()
    tr = cfg["trainer"][MODEL]
    sched = cosine_schedule(cfg[MODEL]["diffusion_steps"])
    table = lookup_table(cfg[MODEL]["gaussian_dim"], cfg["vqvae"]["num_codebook_vectors"]
                         ).to(device)
    params = dict(unet.named_parameters())
    ema = {n: p.detach().clone() for n, p in params.items()}
    p0 = copy.deepcopy(ema)
    total, lr = _schedule(cfg)
    opt = RefAdamW([{"params": list(params.values()), "weight_decay": 0.01}], lr,
                   (0.9, tr["beta2"]))
    out = {"losses": []}
    with precision(control):
        for i in range(steps):
            f = _feed(cfg, seed, i, traffic["batch"], device)
            x0 = table[vq.indices(f["x"])][..., None]
            loss = noise_mse(unet, sched, x0, f["t"], f["noise"])
            unet.zero_grad(set_to_none=True)
            loss.backward()
            if i == 0:
                out["grad"] = {n: float(p.grad.norm()) for n, p in params.items()}
            opt.lr, b1 = onecycle(total, lr, i)
            opt.betas = (b1, tr["beta2"])
            opt.step()
            if i % tr["model_ema_steps"] == 0:
                ema_update(ema.values(), [p.detach() for p in params.values()], ema_decay(cfg))
            out["losses"].append(float(loss.detach()))
    out["delta"] = {n: float((p.detach() - p0[n]).norm()) for n, p in params.items()}
    out["ema_delta"] = {n: float((ema[n] - p0[n]).norm()) for n in params}
    return out
