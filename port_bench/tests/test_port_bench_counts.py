"""The yardstick's arithmetic: the copied bounds give the originals'
numbers at the served path's shapes, the model operation counts from
shapes agree with ``FlopCounterMode`` run on the plain reference, and
every share is reported in %."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import yardstick
from port_bench.reference.gpt import GPT as RefGPT
from port_bench.reference.shuffle_unet import ShuffleUNet as RefUNet
from port_bench.reference.vqgan import VQGAN as RefVQGAN

from .test_port_bench_reference import VQ

ROOT = Path(__file__).resolve().parents[2]
CARD = "NVIDIA H100 80GB HBM3"


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_stack_bound_is_the_originals(dtype):
    import chip_smoke

    want = chip_smoke.decode_stack_bound_ms(getattr(torch, dtype), CARD, None)
    # chip_smoke's module sizes: 12 layers, batch 16, width 1024, 256 positions
    assert yardstick.decode_stack_bound_ms(dtype, CARD, 12, 16, 1024, 256) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shuffle_unit_bound_and_shapes_are_the_originals(dtype):
    from vq_vae_gan_diffusion_torch.models.shuffle_infer import unet_unit_shapes
    from vq_vae_gan_diffusion_torch.utils.profiling import shuffle_unit_bound

    units = yardstick.unet_unit_shapes(256, 96, 64, (1, 2, 4, 8))
    assert units == unet_unit_shapes(256, 96, 64, (1, 2, 4, 8))
    for kind, h, w, ci, co in units:
        assert yardstick.shuffle_unit_bound(kind, h, w, ci, co, 16, dtype, CARD) == \
            shuffle_unit_bound(kind, h, w, ci, co, 16, getattr(torch, dtype), CARD)
    assert yardstick.F32_PEAK_FLOPS == 67e12 and yardstick.BF16_PEAK_FLOPS == 989e12


def test_vqgan_counts_match_the_flop_counter():
    ref = RefVQGAN.from_sizes(VQ, 16, 3)
    x = torch.randn(2, 16, 16, 3)
    assert yardstick.encoder_flops(VQ, 16, 3, 2) == _counted(lambda: ref.indices(x))
    codes = torch.randint(0, 32, (2, 16))
    assert yardstick.decoder_flops(VQ, 3, 2) == _counted(lambda: ref.decode_indices(codes))


def test_gpt_counts_match_the_flop_counter():
    g = {"n_layer": 2, "n_head": 2, "n_embd": 32, "vocab_size": 40}
    ref = RefGPT(40, 16, 2, 2, 32)
    idx = torch.randint(0, 40, (3, 16))
    assert yardstick.gpt_forward_flops(g, 3, 16) == _counted(lambda: ref(idx))
    # decoding does the same projections and head, and attends causally
    full, dec = yardstick.gpt_forward_flops(g, 3, 16), yardstick.gpt_decode_flops(g, 3, 16)
    assert full - dec == 2 * 4 * 3 * 32 * (16 * 16 - 16 * 17 // 2)


def test_unet_count_matches_the_flop_counter():
    u = {"base_dim": 8, "dim_mults": [1, 2], "time_embedding_dim": 256, "in_channels": 1,
         "out_channels": 1}
    ref = RefUNet(10, 256, 1, 1, 8, (1, 2)).eval()
    x, t = torch.randn(3, 16, 8, 1), torch.tensor([1, 2, 3])
    assert yardstick.unet_flops(u, 3, 16, 8) == _counted(lambda: ref(x, t))


def test_every_share_is_in_percent():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    shares = [m for m in spec["per_layer"] + spec["end_to_end"]
              if any(k in m["name"] for k in ("roofline", "mfu", "idle", "pct"))]
    assert shares
    assert all(m["unit"] == "%" for m in shares)
