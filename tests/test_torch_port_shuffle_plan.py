"""The bottleneck kernel's tile plan (``ops.shuffle.bottleneck_plan``), checked
on the CPU at every bottleneck shape of one U-Net forward on the gaussian3d
state [16, 256, 96, 1], the VQ_Official image [16, 1024, 256, 1] and the
mnist config's state [16, 49, 96, 1], and at the off-path shapes of
``chip_smoke.py`` (f): the tiles cover every output pixel once, the shared
memory fits a block (two where a tile allows it), and the halo factor stays
within its limits. The kernel itself runs only on the card (``chip_smoke.py``);
on the CPU ``fused_bottleneck`` is the plain version, exactly.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vq_vae_gan_diffusion_torch.models.shuffle_infer import unet_unit_shapes
from vq_vae_gan_diffusion_torch.ops.shuffle import (MAX_HALO, MAX_TILE, N_BLOCK, SMEM_LIMIT,
                                                    STAGE_BYTES, TARGET_BLOCKS,
                                                    TWO_BLOCKS_SMEM, bottleneck_plan,
                                                    bottleneck_smem, fused_bottleneck, pad_ld,
                                                    reference_bottleneck)

B = 16
GRIDS = {"gaussian3d": (256, 96), "vqofficial": (1024, 256), "mnist": (49, 96)}
OFF_PATH = [("off", 13, 7, 24, 12), ("off", 37, 53, 64, 64), ("off", 19, 29, 48, 40),
            ("off", 9, 11, 1024, 768), ("off", 7, 9, 200, 580)]


def _k1_shapes():
    """(grid, H, W, C_in, C_out) of every distinct bottleneck shape."""
    shapes = []
    for grid, (h, w) in GRIDS.items():
        for kind, uh, uw, c_in, c_out in unet_unit_shapes(h, w):
            if kind == "K1" and (grid, uh, uw, c_in, c_out) not in shapes:
                shapes.append((grid, uh, uw, c_in, c_out))
    return shapes + OFF_PATH


SHAPES = _k1_shapes()
IDS = [f"{g}-{h}x{w}-{ci}-{co}" for g, h, w, ci, co in SHAPES]


def _plan(h, w, c_in, c_out):
    return bottleneck_plan(B, h, w, c_in // 2, c_out // 2)


def _halo(th, tw):
    return (th + 2) * (tw + 2) / (th * tw)


def test_shape_lists_are_the_forwards():
    for grid, (h, w) in GRIDS.items():
        units = unet_unit_shapes(h, w)
        assert len(units) == 43 and [u[0] for u in units].count("K1") == 39, grid
    assert len(SHAPES) == 17 * 3 + len(OFF_PATH)


@pytest.mark.parametrize("grid,h,w,c_in,c_out", SHAPES, ids=IDS)
def test_plan_tiles_cover_every_pixel_once(grid, h, w, c_in, c_out):
    plan = _plan(h, w, c_in, c_out)
    tiles = plan.tiles_h * plan.tiles_w
    assert plan.blocks == B * tiles
    cover = np.zeros((h, w), np.int32)
    for i in range(tiles):
        r0, c0 = plan.tile(i)
        assert 0 <= r0 < h and 0 <= c0 < w, (i, r0, c0)
        cover[r0:r0 + plan.th, c0:c0 + plan.tw] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("grid,h,w,c_in,c_out", SHAPES, ids=IDS)
def test_plan_shared_memory(grid, h, w, c_in, c_out):
    ch, co2 = c_in // 2, c_out // 2
    plan = _plan(h, w, c_in, c_out)
    assert plan.smem == bottleneck_smem(plan.th, plan.tw, ch, co2) <= SMEM_LIMIT
    # within two blocks an SM, and at least TARGET_BLOCKS blocks, wherever
    # some tile within the halo limit allows it
    tiles = [(th, tw) for th in range(1, min(h, MAX_TILE[0]) + 1)
             for tw in range(1, min(w, MAX_TILE[1]) + 1) if _halo(th, tw) <= MAX_HALO]
    two = [(th, tw) for th, tw in tiles if bottleneck_smem(th, tw, ch, co2) <= TWO_BLOCKS_SMEM]
    if two:
        assert plan.smem <= TWO_BLOCKS_SMEM and plan.halo <= MAX_HALO
        if any(B * -(-h // th) * -(-w // tw) >= TARGET_BLOCKS for th, tw in two):
            assert plan.blocks >= TARGET_BLOCKS


@pytest.mark.parametrize("grid,h,w,c_in,c_out",
                         [s for s in SHAPES if s[0] != "off"],
                         ids=[i for s, i in zip(SHAPES, IDS) if s[0] != "off"])
def test_plan_halo_factor(grid, h, w, c_in, c_out):
    """At most 1.5 at VQ_Official's two widest grids, at most 2 everywhere
    on the paths (the kernel runs branch 2's first product on the halo)."""
    plan = _plan(h, w, c_in, c_out)
    assert plan.halo == pytest.approx(_halo(plan.th, plan.tw))
    limit = 1.5 if grid == "vqofficial" and (h, w) in ((1024, 256), (512, 128)) else MAX_HALO
    assert plan.halo <= limit, str(plan)


def test_row_stride_and_shared_memory_arithmetic():
    """Rows of pad_ld(c) floats: at least c, 16-byte aligned, 4 modulo 8
    (the float4s of 8 consecutive rows on 8 distinct bank groups), the
    least such; the block holds the weights' buffers, the halo tile at
    pad_ld(ch) and the tile at pad_ld(max(ch, co2)); a block of a branch
    wider than one pass of the products holds two halo tiles at pad_ld(ch)
    and the tile at pad_ld(co2)."""
    for c in range(1, 513):
        ld = pad_ld(c)
        assert ld >= c and ld % 8 == 4 and not any(v % 8 == 4 for v in range(c, ld))
    assert [pad_ld(c) for c in (6, 12, 16, 32, 64, 128, 256)] == [12, 12, 20, 36, 68, 132, 260]
    assert bottleneck_smem(14, 16, 32, 32) == STAGE_BYTES + 4 * (16 * 18 * 36 + 14 * 16 * 36)
    assert bottleneck_smem(4, 8, 12, 20) == STAGE_BYTES + 4 * (6 * 10 * 12 + 4 * 8 * 20)
    assert bottleneck_smem(2, 3, 512, 384) == STAGE_BYTES + 4 * (2 * 4 * 5 * 516 + 2 * 3 * 388)
    assert bottleneck_smem(2, 3, 100, 290) == STAGE_BYTES + 4 * (2 * 4 * 5 * 100 + 2 * 3 * 292)
    assert bottleneck_smem(2, 3, N_BLOCK, N_BLOCK) == \
        STAGE_BYTES + 4 * (4 * 5 * 260 + 2 * 3 * 260)


def test_plan_is_the_same_for_both_types_and_cached():
    """The kernel holds every intermediate in f32, so the plan takes no
    type: fused_bottleneck launches f32 and bf16 on one tile."""
    assert list(inspect.signature(bottleneck_plan).parameters) == ["b", "h", "w", "ch", "co2"]
    assert bottleneck_plan(B, 64, 16, 256, 256) is bottleneck_plan(B, 64, 16, 256, 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 13, 7, 24, 12), (2, 9, 11, 16, 16)])
def test_cpu_route_is_the_plain_version_exactly(shape, dtype):
    b, h, w, c_in, c_out = shape
    ch, co2 = c_in // 2, c_out // 2
    rng = np.random.default_rng(7)

    def rnd(*s, fan=1):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32) / np.sqrt(fan)).to(dtype)
    folded = dict(k1=rnd(3, 3, ch, fan=9), b1=rnd(ch), w1=rnd(ch, co2, fan=ch), c1=rnd(co2),
                  w2=rnd(ch, ch, fan=ch), c2=rnd(ch), k2=rnd(3, 3, ch, fan=9), b2=rnd(ch),
                  w3=rnd(ch, co2, fan=ch), c3=rnd(co2))
    x = rnd(b, h, w, c_in)
    before = fused_bottleneck.launches
    got = fused_bottleneck(x, folded)
    assert fused_bottleneck.launches == before
    assert got.dtype == dtype and got.shape == (b, h, w, c_out)
    assert torch.equal(got, reference_bottleneck(x, folded))


def test_wrapper_raises_when_the_kernel_refuses_the_shared_memory():
    from vq_vae_gan_diffusion_torch.ops.shuffle import _launch
    with pytest.raises(ValueError, match="shared memory"):
        _launch(lambda *args: -1, "shuffle_bottleneck", 0)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _launch(lambda *args: 9, "shuffle_bottleneck", 0)
    _launch(lambda *args: 0, "shuffle_bottleneck", 0)


def test_plan_refuses_branches_wider_than_the_kernel_takes():
    """Branches wider than one pass of the products are planned (a U-Net of
    base 128 reaches 512 channels a branch); only where not even a 1 x 1
    tile fits a block does the plan refuse."""
    for ch, co2 in ((256, 256), (512, 256), (256, 512), (512, 512), (1024, 1024)):
        plan = bottleneck_plan(B, 8, 8, ch, co2)
        assert plan.smem == bottleneck_smem(plan.th, plan.tw, ch, co2) <= SMEM_LIMIT
    assert bottleneck_smem(1, 1, 2800, 2800) <= SMEM_LIMIT < bottleneck_smem(1, 1, 2900, 2900)
    bottleneck_plan(B, 8, 8, 2800, 2800)
    with pytest.raises(ValueError, match="no tile"):
        bottleneck_plan(B, 8, 8, 2900, 2900)


def test_cuda_source_constants_match_the_plan():
    """csrc/shuffle_units.cu repeats the plan's constants and row stride;
    ops/shuffle.py owns them."""
    from vq_vae_gan_diffusion_torch.ops import shuffle
    src = (Path(shuffle.__file__).resolve().parent.parent / "csrc" / "shuffle_units.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert {k: int(consts[k]) for k in ("kSmemLimit", "kTargetBlocks", "kStageBytes", "kNBlock")} \
        == {"kSmemLimit": SMEM_LIMIT, "kTargetBlocks": TARGET_BLOCKS,
            "kStageBytes": STAGE_BYTES, "kNBlock": N_BLOCK}
    assert "return c4 % 8 == 4 ? c4 : c4 + 4;" in src
    assert "(ch > kNBlock || co2 > kNBlock)" in src
