"""The minGPT prior over the stage-1 VQGAN's codes (the port's
``models/vq_transformer.VQTransformer``).

Serving draws a request's tokens through ``sample_tokens`` (kernel B1 a
position) and decodes them; training runs ``VQTransformerWorker.train_step``.
The reference is :mod:`..reference.vqgan` and :mod:`..reference.gpt`, with
:mod:`..reference.optim`'s AdamW.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .. import yardstick
from ..reference import precision
from ..reference.gpt import GPT as RefGPT, cross_entropy
from ..reference.optim import AdamW as RefAdamW
from ..reference.vqgan import VQGAN as RefVQGAN
from ..weights import derive, draw, generator, gpt_rule, vqgan_rule
from .common import Reading, dataset_tree, images, relative_image_error, run_dir

MODEL = "vqvae_transformer"


def port_config(cfg: dict):
    from vq_vae_gan_diffusion_torch.config import config_from_dict

    return config_from_dict({
        "architecture": {"model_name": MODEL, "vqvae": cfg["vqvae"], MODEL: cfg[MODEL]},
        "dataset": dataset_tree(cfg, MODEL),
        "trainer": {"num_epochs": cfg["trainer"]["num_epochs"], MODEL: cfg["trainer"][MODEL]}})


def _gpt_sizes(cfg: dict) -> dict:
    g = dict(cfg[MODEL])
    g["vocab_size"] = cfg["vqvae"]["num_codebook_vectors"]
    return g


def _composite(cfg: dict, seed: int, device):
    from vq_vae_gan_diffusion_torch.models.vq_transformer import VQTransformer

    with torch.device(device):
        comp = VQTransformer(port_config(cfg))
    draw(dict(comp.vqvae.named_parameters()), vqgan_rule, seed, "vqgan")
    draw(dict(comp.gpt.named_parameters()), gpt_rule, seed, "gpt")
    comp.vqvae.eval().requires_grad_(False)
    return comp


def _reference(cfg: dict, seed: int, device):
    vq = RefVQGAN.from_sizes(cfg["vqvae"], cfg["img_size"], cfg["img_channels"]).to(device)
    g = _gpt_sizes(cfg)
    gpt = RefGPT(g["vocab_size"], g["block_size"], g["n_layer"], g["n_head"],
                 g["n_embd"]).to(device)
    draw(dict(vq.named_parameters()), vqgan_rule, seed, "vqgan")
    draw(dict(gpt.named_parameters()), gpt_rule, seed, "gpt")
    return vq.eval().requires_grad_(False), gpt


# -- serving ---------------------------------------------------------------

def serve_setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    from vq_vae_gan_diffusion_torch.utils.device import resolve_device

    device = resolve_device(str(device))
    comp = _composite(cfg, seed, device).eval()
    return {"cfg": cfg, "comp": comp, "seed": seed, "device": device, "n": traffic["images"],
            "gen": torch.Generator(device=device)}


def serve_inputs(side: dict, i: int, greedy: bool) -> dict:
    """Request i's sampling settings. A greedy request completes a first
    code given to each of its rows (``given``), drawn from the seed, so
    that its rows differ; it runs as many positions as a sampled one."""
    side["gen"].manual_seed(derive(side["seed"], "request", i))
    s = side["cfg"]["serve"]
    if not greedy:
        return {"top_k": s["top_k"], "temperature": s["temperature"], "start": None, "given": 0}
    start = torch.randint(0, side["cfg"]["vqvae"]["num_codebook_vectors"], (side["n"], 1),
                          generator=side["gen"], device=side["device"])
    return {"top_k": 1, "temperature": s["temperature"], "start": start, "given": 1}


def serve_sample(side: dict, n: int, inputs: dict) -> torch.Tensor:
    """The request's codes [n, seq_len]: a greedy request's given first code
    and the rest served."""
    comp, start = side["comp"], inputs["start"]
    steps = None if start is None else steps_per_request(side["cfg"]) - start.shape[1]
    out = comp.sample(n, start_indices=start, steps=steps, top_k=inputs["top_k"],
                      temperature=inputs["temperature"], generator=side["gen"])
    return out if start is None else torch.cat([start, out], 1)


def serve_decode(side: dict, codes: torch.Tensor) -> torch.Tensor:
    return side["comp"].z_to_image(codes)


def serve_warmup(side: dict, n: int) -> None:
    """One request of the cell's shapes, sampled top-k and greedy."""
    for greedy in (False, True):
        serve_decode(side, serve_sample(side, n, serve_inputs(side, -1, greedy)))


def steps_per_request(cfg: dict) -> int:
    return cfg["vqvae"]["latent_size"] ** 2


def request_flops(cfg: dict, n: int) -> int:
    return yardstick.gpt_decode_flops(_gpt_sizes(cfg), n, steps_per_request(cfg)) + \
        yardstick.decoder_flops(cfg["vqvae"], cfg["img_channels"], n)


@torch.no_grad()
def serve_check(cfg: dict, seed: int, kept: List[dict], device, control: bool = False
                ) -> List[Reading]:
    """The reference is run once over SOS and each kept request's codes.
    Over the greedy requests, the widest gap by which a served token's
    logit lies below the reference's best at its position (``logit_gap``;
    the control: the gap of the token that the reference in TF32 puts
    first there). Over the sampled requests, the widest gap by which a
    served token's logit lies below the reference's k-th best, 0 inside
    the top k (``topk_gap``; the control: the worst token of the TF32
    reference's top k). Over the requests that kept their images, the
    decoder's images of the served tokens against the reference's
    (``image_err``; the control: the reference's own in TF32)."""
    # None where nothing of its kind was served to judge
    gap = 0.0 if any(r["greedy"] for r in kept) else None
    topk = 0.0 if not all(r["greedy"] for r in kept) else None
    err = 0.0 if any(r["images"] is not None for r in kept) else None
    if not kept:
        return [("logit_gap", None), ("topk_gap", None), ("image_err", None)]
    vq, gpt = _reference(cfg, seed, device)
    sos, k = cfg[MODEL]["sos_token"], min(cfg["serve"]["top_k"],
                                          cfg["vqvae"]["num_codebook_vectors"])
    for rec in kept:
        tokens = rec["codes"].to(device)
        ctx = torch.cat([torch.full_like(tokens[:, :1], sos), tokens[:, :-1]], 1)
        with precision(False):
            logits = gpt(ctx)
        if control:
            with precision(True):
                low = gpt(ctx)
        served = slice(rec["given"], None)
        logits, tokens = logits[:, served], tokens[:, served]
        if rec["greedy"]:
            pick = low[:, served].argmax(-1) if control else tokens
            best = logits.max(-1).values
            gap = max(gap, float((best - logits.gather(-1, pick[..., None])[..., 0]).max()))
        else:
            kth = logits.topk(k, -1).values[..., -1]
            got = (logits.gather(-1, low[:, served].topk(k, -1).indices).min(-1).values
                   if control else logits.gather(-1, tokens[..., None])[..., 0])
            topk = max(topk, float((kth - got).clamp_min(0).max()))
        if rec["images"] is None:
            continue
        with precision(False):
            ref_img = vq.decode_indices(rec["codes"].to(device))
        if control:
            with precision(True):
                img = vq.decode_indices(rec["codes"].to(device))
        else:
            img = rec["images"].to(device)
        err = max(err, relative_image_error(img, ref_img))
    return [("logit_gap", gap), ("topk_gap", topk), ("image_err", err)]


# -- training --------------------------------------------------------------

def train_setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The worker and its state, as ``VQTransformerWorker.init_state``
    builds it, with the weights drawn on the device: the frozen VQGAN, the
    GPT, AdamW over ``mingpt_param_groups``."""
    from vq_vae_gan_diffusion_torch.train.base import maybe_accumulate
    from vq_vae_gan_diffusion_torch.train.vq_transformer_worker import (
        TransformerState, VQTransformerWorker, mingpt_param_groups)

    pc = port_config(cfg)
    worker = VQTransformerWorker(pc, run_dir(), seed=seed, device=str(device))
    comp = _composite(cfg, seed, worker.device)
    worker.composite = comp
    tr = cfg["trainer"][MODEL]
    opt = torch.optim.AdamW(mingpt_param_groups(comp.gpt), lr=tr["learning_rate"],
                            betas=(tr["beta1"], tr["beta2"]), eps=1e-8)
    worker.state = TransformerState(comp.gpt, maybe_accumulate(opt, worker.trainer_cfg))
    return {"cfg": cfg, "worker": worker, "seed": seed, "device": worker.device,
            "batch": traffic["batch"]}


def _feed(cfg: dict, seed: int, i: int, b: int, device) -> Dict[str, torch.Tensor]:
    """Step i's images and corruption draws, from the seed."""
    g = generator(device, seed, "draws", i)
    t = cfg["vqvae"]["latent_size"] ** 2
    keep = torch.bernoulli(torch.full((b, t), cfg[MODEL]["pkeep"], device=device), generator=g)
    ridx = torch.randint(0, cfg["vqvae"]["num_codebook_vectors"], (b, t), generator=g,
                         device=device)
    return {"x": images(cfg, b, device, seed, "train", i), "keep": keep, "random_indices": ridx}


def train_step(side: dict, i: int) -> torch.Tensor:
    f = _feed(side["cfg"], side["seed"], i, side["batch"], side["device"])
    w = side["worker"]
    w.state, metrics = w.train_step(w.state, f["x"], keep=f["keep"],
                                    random_indices=f["random_indices"])
    return metrics["ce_loss"]


def leaves(side: dict) -> Dict[str, torch.Tensor]:
    return dict(side["worker"].state.gpt.named_parameters())


def ema_leaves(side: dict):
    return None


def first_gradient(side: dict, p: torch.Tensor) -> torch.Tensor:
    """The first step's gradient as AdamW got it: its first moment after one
    step is (1 - beta1) g."""
    opt = side["worker"].state.opt
    opt = getattr(opt, "opt", opt)
    if "exp_avg" not in opt.state.get(p, {}):      # the step never reached the optimizer
        return torch.zeros_like(p)
    return opt.state[p]["exp_avg"] / (1 - side["cfg"]["trainer"][MODEL]["beta1"])


def step_flops(cfg: dict, b: int) -> int:
    t = cfg["vqvae"]["latent_size"] ** 2
    return yardstick.encoder_flops(cfg["vqvae"], cfg["img_size"], cfg["img_channels"], b) + \
        3 * yardstick.gpt_forward_flops(_gpt_sizes(cfg), b, t)


def reference_train(cfg: dict, traffic: dict, seed: int, device, steps: int,
                    control: bool = False) -> dict:
    """The reference's first ``steps`` steps on the same images and draws:
    losses, the first gradient's norm and the change after the steps by
    leaf."""
    vq, gpt = _reference(cfg, seed, device)
    tr = cfg["trainer"][MODEL]
    params = dict(gpt.named_parameters())
    decay = [p for n, p in params.items() if p.dim() == 2 and not n.startswith("tok_emb")]
    rest = [p for n, p in params.items() if not (p.dim() == 2 and not n.startswith("tok_emb"))]
    opt = RefAdamW([{"params": decay, "weight_decay": 0.01},
                    {"params": rest, "weight_decay": 0.0}],
                   tr["learning_rate"], (tr["beta1"], tr["beta2"]))
    p0 = {n: p.detach().clone() for n, p in params.items()}
    sos = cfg[MODEL]["sos_token"]
    out = {"losses": []}
    with precision(control):
        for i in range(steps):
            f = _feed(cfg, seed, i, traffic["batch"], device)
            idx = vq.indices(f["x"])
            keep = f["keep"].long()
            new = keep * idx + (1 - keep) * f["random_indices"]
            ctx = torch.cat([torch.full_like(new[:, :1], sos), new[:, :-1]], 1)
            loss = cross_entropy(gpt(ctx), idx)
            gpt.zero_grad(set_to_none=True)
            loss.backward()
            if i == 0:
                out["grad"] = {n: float(p.grad.norm()) for n, p in params.items()}
            opt.step()
            out["losses"].append(float(loss.detach()))
    out["delta"] = {n: float((p.detach() - p0[n]).norm()) for n, p in params.items()}
    return out
