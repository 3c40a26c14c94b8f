"""The unit kernels' tile plans (``ops.shuffle.bottleneck_plan`` and
``downsample_plan``), checked on the CPU at every bottleneck and downsample
shape of one U-Net forward on the gaussian3d state [16, 256, 96, 1], the
VQ_Official image [16, 1024, 256, 1] and the mnist config's state
[16, 49, 96, 1], and at the off-path shapes of ``chip_smoke.py`` (f): the
tiles cover every output pixel once, the halo tile covers the input pixels
each output reads, the shared memory fits a block (two where a tile allows
it), and the halo factor stays within its limits. The kernels themselves
run only on the card (``chip_smoke.py``); on the CPU ``fused_bottleneck``
and ``fused_downsample`` are the plain versions, exactly.
"""

import ctypes
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vq_vae_gan_diffusion_torch.models.shuffle_infer import unet_unit_shapes
from vq_vae_gan_diffusion_torch.ops.shuffle import (HALO_AIMS, MAX_HALO, MAX_TILE, N_BLOCK,
                                                    SMEM_LIMIT, STAGE_BYTES, TARGET_BLOCKS,
                                                    TWO_BLOCKS_SMEM, bottleneck_plan,
                                                    bottleneck_smem, downsample_plan,
                                                    downsample_smem, fused_bottleneck,
                                                    fused_downsample, pad_ld,
                                                    reference_bottleneck, reference_downsample)

B = 16
GRIDS = {"gaussian3d": (256, 96), "vqofficial": (1024, 256), "mnist": (49, 96)}
OFF_PATH = [("off", 13, 7, 24, 12), ("off", 37, 53, 64, 64), ("off", 19, 29, 48, 40),
            ("off", 9, 11, 1024, 768), ("off", 7, 9, 200, 580)]
# chip_smoke.py (f)'s downsamples off the paths: even and odd grids, last
# tiles short in rows and in columns, widths that are no multiple of 4, and
# branches wider than one 256-column pass of the products
DOWN_OFF_PATH = [("off", 98, 96, 32, 64), ("off", 14, 10, 20, 12), ("off", 13, 7, 20, 12),
                 ("off", 21, 45, 40, 24), ("off", 30, 46, 48, 40), ("off", 17, 27, 18, 26),
                 ("off", 9, 11, 300, 580), ("off", 7, 9, 600, 300)]


def _unit_shapes(kind):
    """(grid, H, W, C_in, C_out) of every distinct shape of one unit kind."""
    shapes = []
    for grid, (h, w) in GRIDS.items():
        for k, uh, uw, c_in, c_out in unet_unit_shapes(h, w):
            if k == kind and (grid, uh, uw, c_in, c_out) not in shapes:
                shapes.append((grid, uh, uw, c_in, c_out))
    return shapes


SHAPES = _unit_shapes("K1") + OFF_PATH
IDS = [f"{g}-{h}x{w}-{ci}-{co}" for g, h, w, ci, co in SHAPES]
DOWN_SHAPES = _unit_shapes("K2") + DOWN_OFF_PATH
# every unit shape, the downsample's tagged K2 (the bottleneck's ids came first)
UNITS = [("K1",) + s for s in SHAPES] + [("K2",) + s for s in DOWN_SHAPES]
UNIT_IDS = IDS + [f"K2-{g}-{h}x{w}-{ci}-{co}" for g, h, w, ci, co in DOWN_SHAPES]
PATH = [(u, i) for u, i in zip(UNITS, UNIT_IDS) if u[1] != "off"]


def _plan(h, w, c_in, c_out, kind="K1"):
    if kind == "K2":
        return downsample_plan(B, h, w, c_in, c_out // 2)
    return bottleneck_plan(B, h, w, c_in // 2, c_out // 2)


def _smem(kind, th, tw, c_in, c_out):
    if kind == "K2":
        return downsample_smem(th, tw, c_in, c_out // 2)
    return bottleneck_smem(th, tw, c_in // 2, c_out // 2)


def _out_grid(kind, h, w):
    return ((h + 1) // 2, (w + 1) // 2) if kind == "K2" else (h, w)


def _halo(th, tw, stride=1):
    return (stride * th + 3 - stride) * (stride * tw + 3 - stride) / (stride ** 2 * th * tw)


def test_shape_lists_are_the_forwards():
    for grid, (h, w) in GRIDS.items():
        units = unet_unit_shapes(h, w)
        assert len(units) == 43 and [u[0] for u in units].count("K1") == 39, grid
    assert len(SHAPES) == 17 * 3 + len(OFF_PATH)
    assert len(DOWN_SHAPES) == 4 * 3 + len(DOWN_OFF_PATH)
    # the downsample's input width C is its branch width co2 on every path
    assert all(c_in == c_out // 2 for _, _, _, c_in, c_out in _unit_shapes("K2"))


@pytest.mark.parametrize("kind,grid,h,w,c_in,c_out", UNITS, ids=UNIT_IDS)
def test_plan_tiles_cover_every_pixel_once(kind, grid, h, w, c_in, c_out):
    plan = _plan(h, w, c_in, c_out, kind)
    ho, wo = _out_grid(kind, h, w)
    tiles = plan.tiles_h * plan.tiles_w
    assert plan.blocks == B * tiles
    cover = np.zeros((ho, wo), np.int32)
    for i in range(tiles):
        r0, c0 = plan.tile(i)
        assert 0 <= r0 < ho and 0 <= c0 < wo, (i, r0, c0)
        cover[r0:r0 + plan.th, c0:c0 + plan.tw] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("kind,grid,h,w,c_in,c_out", UNITS, ids=UNIT_IDS)
def test_plan_halo_tile_covers_what_each_output_reads(kind, grid, h, w, c_in, c_out):
    """Output pixel (r, c) reads input rows s r - 1 .. s r + 1 and columns
    s c - 1 .. s c + 1 (stride s, padding 1); the halo tile of its block
    holds exactly those of its tile's pixels, and the kernel's buffers are
    sized for it."""
    plan = _plan(h, w, c_in, c_out, kind)
    s = 2 if kind == "K2" else 1
    assert plan.stride == s
    ho, wo = _out_grid(kind, h, w)
    for i in range(plan.tiles_h * plan.tiles_w):
        r0, c0 = plan.tile(i)
        y0, x0 = s * r0 - 1, s * c0 - 1          # as the kernels compute it
        rows = [y for r in range(r0, min(r0 + plan.th, ho)) for y in (s * r - 1, s * r, s * r + 1)]
        cols = [x for c in range(c0, min(c0 + plan.tw, wo)) for x in (s * c - 1, s * c, s * c + 1)]
        assert y0 == min(rows) and x0 == min(cols), (i, y0, x0)
        assert max(rows) < y0 + plan.halo_rows and max(cols) < x0 + plan.halo_cols, i
    # a full tile needs the whole halo tile, no more
    assert plan.halo_rows == s * (plan.th - 1) + 3 and plan.halo_cols == s * (plan.tw - 1) + 3
    if kind == "K2":
        halo = (2 * plan.th + 1) * (2 * plan.tw + 1)
        assert plan.halo_rows * plan.halo_cols == halo
        assert plan.halo == pytest.approx(halo / (4 * plan.th * plan.tw))


@pytest.mark.parametrize("kind,grid,h,w,c_in,c_out", UNITS, ids=UNIT_IDS)
def test_plan_shared_memory(kind, grid, h, w, c_in, c_out):
    plan = _plan(h, w, c_in, c_out, kind)
    assert plan.smem == _smem(kind, plan.th, plan.tw, c_in, c_out) <= SMEM_LIMIT
    # within two blocks an SM, and at least TARGET_BLOCKS blocks, wherever
    # some tile within the halo limit allows it
    ho, wo = _out_grid(kind, h, w)
    s = plan.stride
    tiles = [(th, tw) for th in range(1, min(ho, MAX_TILE[0]) + 1)
             for tw in range(1, min(wo, MAX_TILE[1]) + 1) if _halo(th, tw, s) <= MAX_HALO]
    two = [(th, tw) for th, tw in tiles
           if _smem(kind, th, tw, c_in, c_out) <= TWO_BLOCKS_SMEM]
    if two:
        assert plan.smem <= TWO_BLOCKS_SMEM and plan.halo <= MAX_HALO
        if any(B * -(-ho // th) * -(-wo // tw) >= TARGET_BLOCKS for th, tw in two):
            assert plan.blocks >= TARGET_BLOCKS


@pytest.mark.parametrize("kind,grid,h,w,c_in,c_out", [u for u, _ in PATH],
                         ids=[i for _, i in PATH])
def test_plan_halo_factor(kind, grid, h, w, c_in, c_out):
    """The bottleneck: at most 1.5 at VQ_Official's two widest grids, at
    most 2 everywhere on the paths (the kernel runs branch 2's first product
    on the halo). The downsample: at most 1.5 on every path (rows of full
    width ran that product on 1.5 times the rows or more)."""
    plan = _plan(h, w, c_in, c_out, kind)
    assert plan.halo == pytest.approx(_halo(plan.th, plan.tw, plan.stride))
    if kind == "K2":
        limit = HALO_AIMS[0]
    else:
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


def test_downsample_shared_memory_arithmetic():
    """The weights' buffers; x, then t2, over the (2th + 1) x (2tw + 1) halo
    tile at pad_ld(max(C, co2)); u1 at pad_ld(C) and u2 (then y2) at
    pad_ld(co2) over the tile. A branch wider than one pass of the products
    holds x and t2 apart over the halo tile and u1 over the tile."""
    assert downsample_smem(8, 8, 32, 32) == STAGE_BYTES + 4 * (17 * 17 * 36 + 64 * (36 + 36))
    assert downsample_smem(2, 4, 256, 256) == STAGE_BYTES + 4 * (5 * 9 * 260 + 8 * (260 + 260))
    assert downsample_smem(3, 2, 20, 6) == STAGE_BYTES + 4 * (7 * 5 * 20 + 6 * (20 + 12))
    assert downsample_smem(2, 1, 300, 290) == STAGE_BYTES + 4 * (2 * 5 * 3 * 300 + 2 * 300)
    assert downsample_smem(2, 1, 600, 150) == STAGE_BYTES + 4 * (2 * 5 * 3 * 604 + 2 * 604)
    # the halo tile at C = co2 = 32, 8 x 8: 76 KB, two blocks an SM
    assert downsample_smem(8, 8, 32, 32) <= TWO_BLOCKS_SMEM


def test_downsample_plan_is_the_same_for_both_types_and_cached():
    """fused_downsample launches f32 and bf16 on one tile, as the bottleneck."""
    assert list(inspect.signature(downsample_plan).parameters) == ["b", "h", "w", "c", "co2"]
    assert downsample_plan(B, 64, 16, 128, 128) is downsample_plan(B, 64, 16, 128, 128)
    assert downsample_plan(B, 64, 16, 128, 128).stride == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "t_vec"])
@pytest.mark.parametrize("shape", [(2, 13, 7, 20, 12), (2, 10, 12, 16, 32)],
                         ids=["odd", "even"])
def test_cpu_downsample_route_is_the_plain_version_exactly(shape, prologue, dtype):
    b, h, w, c, c_out = shape
    co2 = c_out // 2
    rng = np.random.default_rng(8)

    def rnd(*s, fan=1):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32) / np.sqrt(fan)).to(dtype)
    folded = dict(k1=rnd(3, 3, c, fan=9), b1=rnd(c), w1=rnd(c, co2, fan=c), c1=rnd(co2),
                  w2=rnd(c, co2, fan=c), c2=rnd(co2), k2=rnd(3, 3, co2, fan=9), b2=rnd(co2),
                  w3=rnd(co2, co2, fan=co2), c3=rnd(co2))
    x = rnd(b, h, w, c)
    t_vec = rnd(b, c) if prologue else None
    before = fused_downsample.launches
    got = fused_downsample(x, folded, t_vec)
    assert fused_downsample.launches == before
    assert got.dtype == dtype and got.shape == (b, (h + 1) // 2, (w + 1) // 2, c_out)
    assert torch.equal(got, reference_downsample(x, folded, t_vec))


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


def test_downsample_wrapper_binds_the_c_signature_and_raises_on_refusal():
    """_bind declares each C entry point's arguments as csrc/shuffle_units.cu
    defines them (both units now take th, tw and smem), and a -1 from the
    downsample (bytes short of its tile or above a block's) raises."""
    from vq_vae_gan_diffusion_torch.ops import shuffle
    src = (Path(shuffle.__file__).resolve().parent.parent / "csrc" / "shuffle_units.cu").read_text()

    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self):
            for name in ("shuffle_bottleneck_f32", "shuffle_bottleneck_bf16",
                         "shuffle_downsample_f32", "shuffle_downsample_bf16"):
                setattr(self, name, Fn())
    lib = Lib()
    saved = shuffle.library
    shuffle.library = lambda name: lib
    try:
        shuffle._bind()
    finally:
        shuffle.library = saved
    for name in ("shuffle_bottleneck_f32", "shuffle_bottleneck_bf16",
                 "shuffle_downsample_f32", "shuffle_downsample_bf16"):
        params = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src).group(1).split(",")
        kinds = ["int" if p.split()[0] == "int" else "ptr" for p in params]
        got = ["int" if t is ctypes.c_int else "ptr" for t in getattr(lib, name).argtypes]
        assert got == kinds, name
    assert [p.split()[-1] for p in re.search(
        r'extern "C" int shuffle_downsample_f32\(([^)]*)\)', src).group(1).split(",")][-4:] == \
        ["th", "tw", "smem", "stream"]
    with pytest.raises(ValueError, match="shuffle_downsample.*shared memory"):
        shuffle._launch(lambda *args: -1, "shuffle_downsample", 0)


def test_downsample_plan_refuses_only_where_no_tile_fits():
    """Branches wider than one pass of the products are planned; only where
    not even a 1 x 1 tile fits a block does the plan refuse."""
    for c, co2 in ((256, 256), (512, 256), (256, 512), (300, 290), (1024, 1024)):
        plan = downsample_plan(B, 8, 8, c, co2)
        assert plan.smem == downsample_smem(plan.th, plan.tw, c, co2) <= SMEM_LIMIT
    assert downsample_smem(1, 1, 2800, 2800) <= SMEM_LIMIT < downsample_smem(1, 1, 2900, 2900)
    downsample_plan(B, 8, 8, 2800, 2800)
    with pytest.raises(ValueError, match="no tile of the downsample kernel"):
        downsample_plan(B, 8, 8, 2900, 2900)


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
    # C's bottleneck_smem and downsample_smem, read as Python, give the
    # plan's bytes at every width and tile tried
    for name, ref in (("bottleneck_smem", bottleneck_smem), ("downsample_smem", downsample_smem)):
        fn = _c_function(src, name)
        for th, tw in ((1, 1), (3, 2), (6, 16), (8, 8)):
            for a in (6, 20, 32, 128, 256, 257, 300, 512):
                for b in (12, 32, 256, 290):
                    assert fn(th, tw, a, b) == ref(th, tw, a, b), (name, th, tw, a, b)
    # the kernel's halo tile is the plan's
    assert "const int hw = 2 * tw + 1, Ph = (2 * th + 1) * hw, P = th * tw;" in src
    assert "const int y0 = 2 * r0 - 1, x0 = 2 * c0 - 1" in src


def _c_function(src: str, name: str):
    """A size_t function of ints in csrc/shuffle_units.cu, statements of one
    `const` each with at most one `?:` besides `a > b ? a : b`, as a Python
    function."""
    m = re.search(r"size_t " + name + r"\(([^)]*)\) \{(.*?)\n\}", src, re.S)
    args = [a.split()[-1] for a in m.group(1).split(",")]
    body = []
    for stmt in " ".join(m.group(2).split()).split(";"):
        stmt = stmt.strip().replace("(size_t)", "").replace("sizeof(float)", "4")
        stmt = stmt.replace("||", " or ").replace("&&", " and ")
        stmt = re.sub(r"(\w+) > (\w+) \? \1 : \2", r"max(\1, \2)", stmt)
        if not stmt:
            continue
        if "?" in stmt:
            lhs, expr = stmt.split("=", 1) if not stmt.startswith("return") else ("return", stmt[6:])
            cond, rest = expr.split("?", 1)
            a, b = rest.split(":", 1)
            expr = f"({a}) if ({cond}) else ({b})"
            stmt = f"{lhs}= {expr}" if lhs != "return" else f"return {expr}"
        stmt = re.sub(r"^const (size_t|int) ", "", stmt)
        body.append("    " + stmt.replace("pad_ld(", "_pad_ld("))
    code = f"def {name}({', '.join(args)}):\n" + "\n".join(body)
    scope = {"_pad_ld": pad_ld, "kNBlock": N_BLOCK, "kStageBytes": STAGE_BYTES}
    exec(code, scope)
    return scope[name]
