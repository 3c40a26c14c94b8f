"""The decode stack's block and ring plan (``ops.gpt_decode``'s constants and
``ring_plan``), checked on the CPU against ``csrc/gpt_decode.cu``: the
source's constants and shared-memory functions are the plan's; the ring,
the activation buffers and attention's scratch fit a block's half of the SM
for every instantiation at the served shapes (C 1024, 16 heads, N 256, batch
16) and at the GPT training grid's batch 4; the K splits give whole 16-byte
row copies and are the ones the kernel had before the ring at C = 1024; the
phase stamps' layout is ``stamp_rows``'s. The kernel itself runs only on the
card (``chip_smoke.py`` (c), (l)).
"""

import re
from pathlib import Path

import pytest
import torch

from vq_vae_gan_diffusion_torch.models.mingpt import GPT
from vq_vae_gan_diffusion_torch.ops import gpt_decode as tgd

SRC = (Path(tgd.__file__).resolve().parent.parent / "csrc" / "gpt_decode.cu").read_text()
C, H, N = 1024, 16, 256
# (compute type, weight bits, cache bits) of the ten instantiations of
# decode_stack_kernel<T, W, KV>
INSTANCES = [("f32", 32, 32), ("bf16", 16, 16),
             ("f32", 8, 32), ("f32", 8, 8), ("f32", 4, 32), ("f32", 4, 8),
             ("bf16", 8, 16), ("bf16", 8, 8), ("bf16", 4, 16), ("bf16", 4, 8)]
IDS = [f"{t}-w{w}-kv{k}" for t, w, k in INSTANCES]
SM_SMEM = 233_472          # an H100 SM's shared memory, 1 KB of it reserved a block


def _c_function(name: str):
    """An int function of ints in the source, statements of one `const int`
    each with at most one `?:`, as a Python function (integer division)."""
    m = re.search(r"\nint " + name + r"\(([^)]*)\) \{(.*?)\n\}", SRC, re.S)
    args = [a.split()[-1] for a in m.group(1).split(",")]
    body = []
    for stmt in " ".join(m.group(2).split()).split(";"):
        stmt = stmt.strip().replace("/", "//")
        if not stmt:
            continue
        stmt = re.sub(r"^const int ", "", stmt)
        lhs, expr = ("return", stmt[6:]) if stmt.startswith("return") else stmt.split("=", 1)
        if "?" in expr:
            cond, rest = expr.split("?", 1)
            a, b = rest.split(":", 1)
            expr = f"({a}) if ({cond}) else ({b})"
        body.append(f"    {lhs} {expr}" if lhs == "return" else f"    {lhs}= {expr}")
    code = f"def {name}({', '.join(args)}):\n" + "\n".join(body)
    scope = {"kBT": tgd.BT, "kKT": tgd.KT, "kBlockSmem": tgd.BLOCK_SMEM,
             "kScratchBytes": tgd.SCRATCH_BYTES}
    exec(code, scope)
    return scope[name]


def _old_split(n, k, g=1):
    """The K split before the ring (slices a multiple of 8 columns)."""
    blocks = -(-n // tgd.ROWS_PER_BLOCK)
    s = max(-(-k // tgd.KT), g)
    while k % s or (k // s) % 8 or s % g:
        s += 1
    while blocks * s < 264 and k % (2 * s) == 0 and (k // (2 * s)) % 8 == 0 and k // (2 * s) >= 128:
        s *= 2
    return s


def _split(n, k, g, bits):
    """choose_split of the source: slices also a multiple of 16 bytes."""
    align = 32 if bits == 4 else 16 if bits == 8 else 8
    blocks = -(-n // tgd.ROWS_PER_BLOCK)
    s = max(-(-k // tgd.KT), g)
    while k % s or (k // s) % align or s % g:
        s += 1
    while (blocks * s < 264 and k % (2 * s) == 0 and (k // (2 * s)) % align == 0
           and k // (2 * s) >= 128):
        s *= 2
    return s


def _products(c, bits):
    """(N, K, groups) of QKV, proj, fc1 and fc2 for weights of ``bits``."""
    g, g2 = (8, 16) if bits == 4 else (1, 2) if bits == 8 else (1, 1)
    return [(3 * c, c, g), (c, c, g), (4 * c, c, g), (c, 4 * c, g2)]


def test_cuda_source_constants_match_the_plan():
    """csrc/gpt_decode.cu repeats the block's and the ring's constants and
    its shared-memory functions; ops/gpt_decode.py owns them."""
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", SRC)}
    assert {k: consts[k] for k in ("kThreads", "kBlocksPerSm", "kRowsPerWarp", "kBT", "kKT",
                                   "kBlockSmem", "kScratchBytes")} == {
        "kThreads": tgd.CONSUMER_THREADS, "kBlocksPerSm": tgd.BLOCKS_PER_SM,
        "kRowsPerWarp": tgd.ROWS_PER_BLOCK // (tgd.CONSUMER_THREADS // 32), "kBT": tgd.BT,
        "kKT": tgd.KT, "kBlockSmem": tgd.BLOCK_SMEM, "kScratchBytes": tgd.SCRATCH_BYTES}
    assert "constexpr int kBlockThreads = kThreads + 32;" in SRC
    assert tgd.BLOCK_THREADS == tgd.CONSUMER_THREADS + 32
    assert "constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;" in SRC
    assert "__launch_bounds__(kBlockThreads, kBlocksPerSm)" in SRC
    assert "static constexpr int kWBytes = kRowsPerBlock * kRowBytes;" in SRC
    assert "static constexpr int kRowBytes = kKT * kBits<W> / 8;" in SRC
    for bits in (32, 16, 8, 4):
        assert tgd.slot_bytes(bits) == tgd.ROWS_PER_BLOCK * tgd.KT * bits // 8
    # attention's scratch as the launch computes it
    assert "consumer_bytes((int)sizeof(float) * (2 * d + kThreads * Vec<KV>::n + N))" in SRC
    consumer, slots, smem = (_c_function(n) for n in ("consumer_bytes", "ring_slots",
                                                       "decode_smem"))
    for attn in (0, 5632, 32768, 32769, 40000, 50176):
        assert consumer(attn) == tgd.consumer_bytes(attn), attn
        for bits in (32, 16, 8, 4):
            slot = tgd.slot_bytes(bits)
            assert slots(slot, consumer(attn)) == tgd.ring_slots(slot, tgd.consumer_bytes(attn))
            n = tgd.ring_slots(slot, tgd.consumer_bytes(attn))
            assert smem(slot, n, consumer(attn)) == tgd.decode_smem(slot, n, consumer(attn))


@pytest.mark.parametrize("batch", [16, 4])
@pytest.mark.parametrize("instance", INSTANCES, ids=IDS)
def test_ring_fits_a_block_at_the_served_shapes(instance, batch):
    """Ring + activation buffers + attention's scratch + the mbarriers and
    the static scratch fit a block's half of the SM (so two blocks an SM,
    each within 232,448 bytes), with at least two slots: as many as the
    most tiles a block takes of one product on the card's 264 blocks, so a
    product's weights can all be in the ring when its phase starts. The plan
    does not depend on the batch (its virtual blocks of 16 rows do)."""
    _, wbits, kvbits = instance
    plan = tgd.ring_plan(wbits, kvbits, C, H, N)
    assert plan["slots"] >= 2
    assert plan["block"] <= tgd.BLOCK_SMEM <= tgd.SMEM_LIMIT
    assert 2 * (plan["block"] + 1024) <= SM_SMEM
    # nothing more fits: one slot more would not
    assert tgd.decode_smem(plan["slot"], plan["slots"] + 1, plan["consumer"]) \
        + tgd.SCRATCH_BYTES > tgd.BLOCK_SMEM
    # the attention scratch and the activation buffers share the consumer area
    assert plan["consumer"] >= max(2 * tgd.BT * tgd.KT * 4,
                                   tgd.attention_bytes(C // H, 128 // kvbits, N))
    qbits = 0 if wbits >= 16 else wbits
    nbb = -(-batch // tgd.BT)
    tiles = max(-(-(-(-n // tgd.ROWS_PER_BLOCK) * nbb * _split(n, k, g, qbits)) // 264)
                for n, k, g in _products(C, qbits))
    assert tiles <= plan["slots"]


@pytest.mark.parametrize("instance", INSTANCES, ids=IDS)
def test_ring_has_a_slot_at_the_widest_cache(instance):
    """At the most cache rows and the widest head the wrapper takes (N 8192,
    head width 128), attention's scratch still leaves the ring a slot."""
    _, wbits, kvbits = instance
    plan = tgd.ring_plan(wbits, kvbits, 2048, 16, 8192)
    assert plan["slots"] >= 1 and plan["block"] <= tgd.BLOCK_SMEM


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_splits_give_whole_16_byte_row_copies(bits):
    """Every K slice of every product is a whole number of 16-byte row
    copies at each width the wrapper takes for the weights' type, no slice
    straddles a scale group, and at C = 1024 the splits are the ones before
    the ring."""
    widths = {0: [8, 40, 64, 72, 512, 1000, 1024, 4096], 8: [16, 48, 512, 1024, 4096],
              4: [256, 768, 1024, 4096]}[bits]
    for c in widths:
        for n, k, g in _products(c, bits):
            s = _split(n, k, g, bits)
            kslice = k // s
            assert k % s == 0 and s % g == 0, (c, n, k)
            assert kslice * (bits or 32) // 8 % 16 == 0 or (bits == 0 and kslice % 8 == 0)
            assert kslice <= tgd.KT
    for n, k, g in _products(1024, bits):
        assert _split(n, k, g, bits) == _old_split(n, k, g)
    assert "const int align = bits == 4 ? 32 : bits == 8 ? 16 : 8;" in SRC


def test_narrow_quantized_widths_are_refused():
    """The row copies need 16-byte slices: int8 weights at C % 16 != 0 and
    int4 at C % 256 != 0 are refused before any launch."""
    for quant, c, heads, match in (("int8", 40, 5, "C % 16"), ("int4", 64, 2, "C % 256"),
                                   ("int4", 128, 2, "C % 256")):
        gpt = GPT(vocab_size=16, block_size=8, n_layer=1, n_head=heads, n_embd=c)
        packed = tgd.pack_decode_params(gpt, quant=quant)
        with pytest.raises(ValueError, match=re.escape(match)):
            tgd._check_cuda_args(torch.zeros(1, c), packed, torch.zeros(1, 1, 4, 2 * c), 0,
                                 heads)
    gpt = GPT(vocab_size=16, block_size=8, n_layer=1, n_head=2, n_embd=256)
    tgd._check_cuda_args(torch.zeros(1, 256), tgd.pack_decode_params(gpt, quant="int4"),
                         torch.zeros(1, 1, 4, 512), 0, 2)


def test_stamp_layout_is_stamp_rows():
    """The launch writes 8L + 2 rows of stamps and three ring counters for
    each product, in RING_PRODUCTS' order, and refuses a buffer that does not
    hold them."""
    for n_layer in (1, 2, 12):
        assert tgd.stamp_rows(n_layer) == 8 * n_layer + 2 + 3 * len(tgd.RING_PRODUCTS)
    assert tgd.RING_PRODUCTS == ("QKV", "proj", "fc1", "fc2")
    assert "st.s[1] = st.row + 13;" in SRC            # after 8L barriers st.row is 8L + 1
    assert "const int r = 8 * L + 2 + 3 * prod;" in SRC
    assert "for (int r = 8 * a.L + 2; r < 8 * a.L + 14; ++r)" in SRC
    assert "if (2 + (long long)(8 * L + 14) * (grid + 1) > g_stamps_cap)" in SRC
    for prod, name in enumerate(tgd.RING_PRODUCTS):
        layer = {"QKV": "p.qkv", "proj": "p.proj", "fc1": "p.fc1", "fc2": "p.fc2"}[name]
        assert re.search(rf"gemv_phase<W>\(layer_gemv<W>\({re.escape(layer)}, .*, {prod}, a\.L\)",
                         SRC), name
