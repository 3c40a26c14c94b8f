"""The plain reference against the port's modules at tiny widths on the
CPU: the same weights, drawn from a seed into both by name, give the same
results. This file may import the port; the reference itself does not."""

import math

import pytest
import torch

from port_bench.reference import ddpm as rddpm
from port_bench.reference import optim as roptim
from port_bench.reference.gpt import GPT as RefGPT
from port_bench.reference.shuffle_unet import ShuffleUNet as RefUNet
from port_bench.reference.vqgan import VQGAN as RefVQGAN
from port_bench.weights import draw, gpt_rule, unet_rule, vqgan_rule

VQ = {"latent_channels": 8, "latent_size": 4, "intermediate_channels": [8, 8, 16],
      "num_residual_blocks_encoder": 2, "num_residual_blocks_decoder": 3,
      "attention_resolution": [4], "num_codebook_vectors": 32}


def _vqgan_pair(seed=5):
    from vq_vae_gan_diffusion_torch.models.vqvae import VQVAE

    port = VQVAE(16, 3, 8, 4, (8, 8, 16), 2, 3, 0.0, (4,), 32).eval()
    ref = RefVQGAN.from_sizes(VQ, 16, 3).eval()
    draw(dict(port.named_parameters()), vqgan_rule, seed, "vqgan")
    draw(dict(ref.named_parameters()), vqgan_rule, seed, "vqgan")
    return port, ref


def _gpt_pair(seed=5):
    from vq_vae_gan_diffusion_torch.models.mingpt import GPT

    port, ref = GPT(32, 32, 2, 2, 32), RefGPT(32, 32, 2, 2, 32)
    draw(dict(port.named_parameters()), gpt_rule, seed, "gpt")
    draw(dict(ref.named_parameters()), gpt_rule, seed, "gpt")
    return port, ref


def _unet_pair(seed=5):
    from vq_vae_gan_diffusion_torch.models.unet_shuffle import ShuffleUNet

    port, ref = ShuffleUNet(10, 256, 1, 1, 8, (1, 2)), RefUNet(10, 256, 1, 1, 8, (1, 2))
    draw(dict(port.named_parameters()), unet_rule, seed, "unet")
    draw(dict(ref.named_parameters()), unet_rule, seed, "unet")
    return port, ref


@pytest.mark.parametrize("pair", [_vqgan_pair, _gpt_pair, _unet_pair])
def test_parameter_names_match_the_port(pair):
    port, ref = pair()
    shapes = lambda m: {n: tuple(p.shape) for n, p in m.named_parameters()}   # noqa: E731
    assert shapes(port) == shapes(ref)
    for (n, p), (_, q) in zip(sorted(port.named_parameters()), sorted(ref.named_parameters())):
        assert torch.equal(p, q), n


def test_vqgan_encoder_quantizer_and_decoder():
    port, ref = _vqgan_pair()
    x = torch.randn(3, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, idx, _ = port.encode(x)
        assert torch.equal(ref.indices(x), idx.reshape(3, -1))
        codes = torch.randint(0, 32, (3, 16), generator=torch.Generator().manual_seed(2))
        torch.testing.assert_close(ref.decode_indices(codes), port.decode_indices(codes),
                                   rtol=1e-5, atol=1e-5)


def test_gpt_forward_and_the_decode_route():
    from vq_vae_gan_diffusion_torch.models.mingpt import fused_step

    port, ref = _gpt_pair()
    idx = torch.randint(0, 32, (2, 12), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = ref(idx)
        torch.testing.assert_close(port(idx), want, rtol=1e-5, atol=1e-5)
        step = fused_step(port, 2, 12)          # the served route, teacher-forced
        got = torch.stack([step(idx[:, t], t) for t in range(12)], 1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["eval", "folded"])
def test_unet_eval_forward(mode):
    from vq_vae_gan_diffusion_torch.models.shuffle_infer import eval_forward

    port, ref = _unet_pair()
    g = torch.Generator().manual_seed(4)
    for m in (port, ref):       # moved running statistics, the same in both
        for n, b in m.named_buffers():
            if n.endswith("running_mean"):
                b.copy_(torch.linspace(-0.2, 0.2, b.numel()))
            elif n.endswith("running_var"):
                b.copy_(torch.linspace(0.5, 1.5, b.numel()))
    x, t = torch.randn(3, 16, 8, 1, generator=g), torch.tensor([0, 4, 9])
    fwd = eval_forward(port, mode == "folded")
    with torch.no_grad():
        torch.testing.assert_close(fwd(x, t), ref.eval()(x, t), rtol=1e-4, atol=1e-5)


def test_unet_train_mode_and_running_statistics():
    port, ref = _unet_pair()
    g = torch.Generator().manual_seed(6)
    x, t = torch.randn(4, 16, 8, 1, generator=g), torch.tensor([1, 2, 3, 8])
    out_p, out_r = port.train()(x, None, t), ref.train()(x, t)
    torch.testing.assert_close(out_p, out_r, rtol=1e-4, atol=1e-5)
    out_p.square().mean().backward()
    out_r.square().mean().backward()
    grads = dict(ref.named_parameters())
    for n, p in port.named_parameters():
        # a bias ahead of a BatchNorm has a gradient of zero up to round-off
        torch.testing.assert_close(p.grad, grads[n].grad, rtol=1e-3, atol=1e-5)
    bufs = dict(ref.named_buffers())
    for n, b in port.named_buffers():
        if "running" in n:
            torch.testing.assert_close(b, bufs[n], rtol=1e-5, atol=1e-6)


def test_lookup_table_schedule_and_chain_against_the_port():
    from vq_vae_gan_diffusion_torch.diffusion.gaussian import make_schedule
    from vq_vae_gan_diffusion_torch.diffusion.gaussian3d import (GaussianDiffusion3D,
                                                                   positional_encoding_table)

    assert torch.equal(rddpm.lookup_table(8, 32), torch.from_numpy(positional_encoding_table(8, 32)))
    port_s, ref_s = make_schedule(10, "cosine"), rddpm.cosine_schedule(10)
    for a, b in (("betas", "betas"), ("alphas_cumprod", "ac"),
                 ("alphas_cumprod_prev", "ac_prev")):
        assert torch.equal(getattr(port_s, a), ref_s[b])
    _, unet = _unet_pair()
    unet.eval()
    g = torch.Generator().manual_seed(7)
    x_T, noise = torch.randn(2, 16, 8, 1, generator=g), torch.randn(10, 2, 16, 8, 1, generator=g)
    diff = GaussianDiffusion3D((16, 8), 1, 10, 10, lambda x, c, t: unet(x, t), sample_method="ddpm")
    with torch.no_grad():
        want = diff.ddpm_sample(2, x_T=x_T, step_noise=noise) * 2 - 1
        got = rddpm.ddpm_chain(unet, ref_s, x_T, noise)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    t = torch.tensor([0, 7])
    with torch.no_grad():
        torch.testing.assert_close(rddpm.noise_mse(unet, ref_s, x_T, t, noise[0]),
                                   diff.loss(x_T, t=t, noise=noise[0]))


def test_adamw_onecycle_and_ema_against_torch_and_the_port():
    from vq_vae_gan_diffusion_torch.utils.ema import ema_update
    from vq_vae_gan_diffusion_torch.utils.schedules import torch_onecycle_schedules

    lr_fn, b1_fn = torch_onecycle_schedules(40, 1e-3)
    for s in range(0, 45, 3):
        assert roptim.onecycle(40, 1e-3, s) == (lr_fn(s), b1_fn(s))
    g = torch.Generator().manual_seed(8)
    a = [torch.randn(5, 3, generator=g, requires_grad=True) for _ in range(2)]
    b = [p.detach().clone().requires_grad_(True) for p in a]
    opt = torch.optim.AdamW(a, lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01)
    ref = roptim.AdamW([{"params": b, "weight_decay": 0.01}], 1e-3, (0.9, 0.95))
    for step in range(3):
        grads = [torch.randn(5, 3, generator=g) for _ in a]
        lr, b1 = roptim.onecycle(40, 1e-3, step)
        for group in opt.param_groups:
            group["lr"], group["betas"] = lr, (b1, 0.95)
        ref.lr, ref.betas = lr, (b1, 0.95)
        for p, q, gr in zip(a, b, grads):
            p.grad, q.grad = gr.clone(), gr.clone()
        opt.step()
        ref.step()
    for p, q in zip(a, b):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)
    e1 = torch.nn.Linear(3, 2)
    e2, m = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    e2.load_state_dict(e1.state_dict())
    ema_update(e1, m, 0.9)
    roptim.ema_update(list(e2.parameters()), [p.detach() for p in m.parameters()], 0.9)
    for p, q in zip(e1.parameters(), e2.parameters()):
        torch.testing.assert_close(p, q)
    assert math.isclose(roptim.onecycle(40, 1e-3, 0)[1], 0.95, rel_tol=1e-6)


def test_the_reference_imports_nothing_of_the_port():
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / "reference"
    for path in root.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("vq_vae_gan_diffusion_torch", "jax",
                                                  "vq_vae_gan_diffusion_tpu"), (path, name)


@pytest.mark.parametrize("base,mults", [(8, [1, 2]), (16, [1, 2, 4])])
def test_the_port_builds_the_unet_the_configuration_states(base, mults):
    """The gaussian3d configuration's U-Net widths reach the port (through
    its ``base_dim`` and ``unet_dim_mults``) and the reference alike."""
    from port_bench.run import Bench

    from .tiny import tiny

    bench = Bench()
    cfg = tiny(bench.config("gaussian3d_flowers256"))
    cfg["unet"].update(base_dim=base, dim_mults=mults)
    fam = bench.family(cfg)
    comp, (_, ref) = fam._composite(cfg, 3, "cpu"), fam._reference(cfg, 3, "cpu")
    shapes = lambda m: {n: tuple(p.shape) for n, p in m.named_parameters()}
    assert shapes(comp.unet) == shapes(ref)
