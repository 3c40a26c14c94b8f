"""The port's VQ_Official prior against the benchmark's plain reference
(``port_bench/reference/discrete.py``) on seeded random weights at a tiny
size on the CPU: the schedule's buffers, ``q_pred``, ``predict_start``, the
posteriors and whole reverse steps of the served chain; the
``vqofficial`` family's check, sound on the program and failing planted
faults; the reference's imports; and the cell's readers: their bounds
against the port's, their unit shapes, and nothing read without a trace.

The port's VQ_Official U-Net has fixed widths (base 64, mults 1, 2, 4,
8); the tests build it at the tiny configuration's widths, as the
configuration states them for the reference.

Tolerances: the schedule and ``q_pred`` within 1e-5, log(1 - e^a) within
2e-4 of its size (the port takes it in float32 where the reference takes
it in float64); x̂_0's
and the posterior's log-probabilities within 1e-4 (K1 and K2's folded
units and the structured posterior against cuDNN-free plain modules and
the dense posterior, on log-onehot inputs of -69); picks identical.
"""

import ast
import contextlib
import math
from pathlib import Path

import pytest
import torch

from port_bench.posterior_bound import posterior_bound
from port_bench.reference import discrete as rd
from port_bench.run import Bench
from port_bench.tests.tiny import tiny
from port_bench.tests.vqofficial_faults import late_step, pad_dropped
from vq_vae_gan_diffusion_torch.diffusion import discrete as td
from vq_vae_gan_diffusion_torch.models import vq_diffusion_composite as comp_mod
from vq_vae_gan_diffusion_torch.models.shuffle_infer import unet_unit_shapes
from vq_vae_gan_diffusion_torch.profile_shuffle import UNIT_GRIDS
from vq_vae_gan_diffusion_torch.utils.profiling import posterior_bound as port_posterior_bound

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 32 + 29
CARD = "NVIDIA H100 80GB HBM3"
BENCH = Bench()
FAMILY = BENCH.family(BENCH.config("vqofficial_flowers256"))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    """The cell's configuration cut by ``tiny`` (K 32 classes, N 16
    positions, 10 steps, a U-Net of base 8, mults 1, 2), the port's U-Net
    built at those widths."""
    c = tiny(BENCH.config("vqofficial_flowers256"))
    u = c["unet"]
    with pytest.MonkeyPatch.context() as mp:
        full = comp_mod.ShuffleUNet
        mp.setattr(comp_mod, "ShuffleUNet",
                   lambda T, emb, c_in, c_out, base, mults, _f=full:
                   _f(T, emb, c_in, c_out, u["base_dim"], tuple(u["dim_mults"])))
        yield c


@pytest.mark.parametrize("steps,k", [(10, 32), (1000, 1024)])
def test_schedule_buffers_match_the_reference(steps, k):
    """Every buffer within 1e-5, but log(1 - e^a) within 2e-4 of its size:
    the port takes it in float32 from the float32 log γ where the reference
    takes it in float64, and 1 - γ̄ loses digits as γ̄ nears 1 (it enters
    only mask rows that the posterior replaces or pads). The padding entry
    T of the cumulative buffers, where the reference's log β̄ and log γ̄ are
    -inf, holds log 1e-30 in the port (its clip, as in the JAX package)."""
    port, ref = td.make_discrete_schedule(steps, k), rd.schedule(steps, k)
    assert set(port._fields) == set(ref)
    for name in port._fields:
        got, want = getattr(port, name), ref[name]
        assert got.shape == want.shape, name
        finite = torch.isfinite(want)
        rtol = 2e-4 if name.startswith("log_1_min") else 0
        torch.testing.assert_close(got[finite], want[finite], rtol=rtol, atol=1e-5, msg=name)
        torch.testing.assert_close(got[~finite], torch.full_like(got[~finite], math.log(1e-30)))
    assert not torch.isfinite(ref["log_cumprod_bt"][steps]) and \
        not torch.isfinite(ref["log_cumprod_ct"][steps])


def test_q_pred_matches_the_reference():
    b, n, k, steps = 2, 16, 32, 10
    port = td.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=steps)
    sched = rd.schedule(steps, k)
    g = torch.Generator().manual_seed(0)
    log_x = torch.log_softmax(3 * torch.randn(b, n, k, generator=g), -1)
    for tv in (-1, 0, 1, steps // 2, steps - 1):
        t = torch.full((b,), tv)
        got = port.q_pred(log_x, t)
        want = rd.q_pred(sched, log_x.transpose(1, 2), t).transpose(1, 2)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5, msg=f"t={tv}")
        if tv >= 0:
            got = port.q_pred_one_timestep(log_x, t)
            want = rd.q_pred_one_timestep(sched, log_x.transpose(1, 2), t).transpose(1, 2)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5, msg=f"one step t={tv}")


def _program_and_reference(cfg):
    """The family's composite (weights drawn from the seed, the U-Net's
    folded route) with its prior bound, and the reference U-Net."""
    comp = FAMILY._composite(cfg, SEED, torch.device("cpu"))
    _, unet = FAMILY._reference(cfg, SEED, torch.device("cpu"))
    return comp, comp.bind(), unet.eval()


def _states(cfg, b, g):
    """A dense chain-init state and an index carry with masked positions."""
    _, k, n = FAMILY._sizes(cfg)
    log_u = torch.rand(b, n, k, generator=g).log()
    x = torch.randint(0, k, (b, n), generator=g)
    x[:, :3] = k - 1
    return log_u, x


def test_predict_start_and_posteriors_match_the_reference(cfg):
    """x̂_0 on the dense chain-init state and on an index carry, through the
    port's folded U-Net, against the reference's; the dense and the
    structured posteriors on the same x̂_0 against the reference's, their
    log-probabilities clamped below at -50. At t = 0 the port's padding
    entry log γ̄_T (log 1e-30 where the reference's is -inf) lifts the mask
    class of a masked position from e^-69 to about e^-57, which no Gumbel
    draw can pick."""
    _, prior, unet = _program_and_reference(cfg)
    steps, k, _ = FAMILY._sizes(cfg)
    sched = rd.schedule(steps, k)
    g = torch.Generator().manual_seed(1)
    log_u, x = _states(cfg, 2, g)
    onehot = rd.index_to_log_onehot(x, k)
    assert torch.equal(onehot.transpose(1, 2), td.index_to_log_onehot(x, k))

    def close(got, want):
        torch.testing.assert_close(got.transpose(1, 2).clamp(min=-50), want.clamp(min=-50),
                                   rtol=0, atol=1e-4)
    for tv in (0, 1, steps - 1):
        t = torch.full((2,), tv)
        x0, x0_idx = prior.predict_start(log_u, t), prior.predict_start_idx(x, t)
        ref_x0 = rd.predict_start(unet, log_u.transpose(1, 2), t)
        ref_x0_idx = rd.predict_start(unet, onehot, t)
        torch.testing.assert_close(x0.transpose(1, 2), ref_x0, rtol=0, atol=1e-4)
        torch.testing.assert_close(x0_idx.transpose(1, 2), ref_x0_idx, rtol=0, atol=1e-4)
        close(prior.q_posterior(x0, log_u, t),
              rd.q_posterior(sched, ref_x0, log_u.transpose(1, 2), t))
        want = rd.q_posterior(sched, ref_x0_idx, onehot, t)
        close(prior.q_posterior_idx(x0_idx, x, t), want)
        close(prior.q_posterior(x0_idx, onehot.transpose(1, 2), t), want)


def test_served_chain_steps_match_the_reference(cfg):
    """The family's timed chain (dense first step, then B6's plain version
    at every structured step): from each state it held and that step's
    noise, the reference picks what the chain picked."""
    comp, _, unet = _program_and_reference(cfg)
    steps, k, _ = FAMILY._sizes(cfg)
    sched = rd.schedule(steps, k)
    side = {"cfg": cfg, "comp": comp, "seed": SEED, "device": torch.device("cpu")}
    film = FAMILY.serve_sample(side, 2, {"i": 0})
    assert film.shape == (2, steps, FAMILY._sizes(cfg)[2])
    noise = FAMILY._noise(cfg, SEED, 0, 2, torch.device("cpu"))
    state = noise["init_uniform"].log().transpose(1, 2)
    for s in range(steps):
        t = torch.full((2,), steps - 1 - s)
        log_post = rd.q_posterior(sched, rd.predict_start(unet, state, t), state, t)
        assert torch.equal(rd.pick(log_post, noise["step_gumbel"][s].transpose(1, 2)),
                           film[:, s]), f"step {s}"
        state = rd.index_to_log_onehot(film[:, s], k)


@pytest.mark.parametrize("fault,fails", [(None, None), (late_step, "pick_gap"),
                                         (pad_dropped, "logit_gap")])
def test_the_check_is_sound_on_the_program_and_fails_a_planted_fault(cfg, fault, fails):
    dev = torch.device("cpu")
    with fault() if fault else contextlib.nullcontext():
        side = FAMILY.serve_setup(cfg, {}, SEED, dev)
        film = FAMILY.serve_sample(side, 2, {"i": 1})
        kept = [{"i": 1, "codes": film, "images": FAMILY.serve_decode(side, film)},
                {"i": 0, "codes": film, "images": None}]
        checks = dict(FAMILY.serve_check(cfg, SEED, kept, dev))
    over = {name for name, v in checks.items() if v > cfg["limits"][name]}
    assert over == ({fails} if fails else set()), checks
    assert dict(FAMILY.serve_check(cfg, SEED, kept[1:], dev)) == \
        {"logit_gap": None, "pick_gap": None, "image_err": None}


def test_checked_steps_are_drawn_from_the_seed_among_the_chain():
    full = BENCH.config("vqofficial_flowers256")
    steps = FAMILY.checked_steps(full, SEED, 0)
    assert steps[0] == 0 and steps[-1] == 999 and len(set(steps)) == 10
    assert steps == sorted(steps) == FAMILY.checked_steps(full, SEED, 0)
    assert steps != FAMILY.checked_steps(full, SEED + 1, 0)


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." * node.level + (node.module or ""))
    return out


def test_the_reference_imports_nothing_of_the_port_or_of_jax():
    ref = ROOT / "port_bench" / "reference"
    seen = _imports(ref / "discrete.py") | _imports(ref / "shuffle_unet.py") | \
        _imports(ref / "__init__.py")
    assert {m for m in seen if not m.startswith(".")} <= \
        {"__future__", "typing", "contextlib", "numpy", "torch", "torch.nn.functional", "torch.nn"}
    assert {m for m in seen if m.startswith(".")} <= {".shuffle_unet"}


@pytest.mark.parametrize("b,n,km1,dtype", [(4, 256, 1023, "float32"), (16, 256, 1023, "float32"),
                                           (4, 256, 1023, "bfloat16"), (3, 49, 256, "float32")])
def test_the_posterior_bound_is_the_ports(b, n, km1, dtype):
    assert posterior_bound(b, n, km1, dtype, CARD) == port_posterior_bound(
        b, n, km1, getattr(torch, dtype), False, 0, CARD)


def test_the_k1_and_k2_readers_take_the_ports_unit_shapes():
    from port_bench.metrics.discrete_unet import units

    full = BENCH.config("vqofficial_flowers256")
    want = unet_unit_shapes(*UNIT_GRIDS["vqofficial"])
    assert units(full, "K1") + units(full, "K2") == \
        [s for s in want if s[0] == "K1"] + [s for s in want if s[0] == "K2"]
    assert (len(units(full, "K1")), len(units(full, "K2"))) == (39, 4)


def _kernel_ctx(kernels, host=()):
    full = BENCH.config("vqofficial_flowers256")
    trace = {"kernels": kernels, "device": list(kernels), "host": list(host)}
    return {"trace": trace, "config": full, "traffic": BENCH.traffic("serve_closed_4"),
            "device": {"kind": CARD}}


@pytest.mark.parametrize("metric", ["k1_roofline.vqofficial", "k2_roofline.vqofficial",
                                    "posterior_roofline", "step_gap_us.vqofficial",
                                    "reverse_step_ms.vqofficial"])
def test_each_reader_reads_nothing_without_its_data(metric):
    reader = BENCH.reader(metric)
    none = {"trace": None, "result": {"phases": {}}, "config": BENCH.config(
        "vqofficial_flowers256"), "family": FAMILY}
    assert reader.read(none) is None
    if metric != "reverse_step_ms.vqofficial":
        ctx = _kernel_ctx([("other_kernel", 0.0, 10.0)], [("gpt.position", 0.0, 10.0)])
        assert reader.read(ctx) is None


def test_the_roofline_readers_divide_the_bound_by_the_device_time():
    """Two forwards' K1 and K2 launches and two B6 launches, each taking
    twice its bound, read 50%."""
    full = BENCH.config("vqofficial_flowers256")
    from port_bench import yardstick
    from port_bench.metrics.discrete_unet import units

    kernels, clock = [], 0.0
    for kind, name in (("K1", "bottleneck_kernel<float>"), ("K2", "downsample_kernel<float>")):
        for _ in range(2):
            for k, h, w, ci, co in units(full, kind):
                us = 2e3 * max(yardstick.shuffle_unit_bound(k, h, w, ci, co, 4, "float32", CARD))
                kernels.append((name, clock, clock + us))
                clock += us
    b6 = 2e3 * max(posterior_bound(4, 256, 1023, "float32", CARD))
    kernels += [("posterior_kernel<float, false, true>", clock, clock + b6),
                ("posterior_kernel<float, false, true>", clock + b6, clock + 2 * b6)]
    ctx = _kernel_ctx(kernels)
    for metric in ("k1_roofline.vqofficial", "k2_roofline.vqofficial", "posterior_roofline"):
        assert BENCH.reader(metric).read(ctx) == pytest.approx(50.0), metric


def test_step_gap_reader_charges_the_gaps_under_discrete_step_a_step():
    """Gaps whose middle lies under a ``discrete.step`` span count (3 + 5
    us); the gaps under the chain alone (4 + 4 us) and after it (6 us) do
    not."""
    host = [("discrete.chain", 0, 60), ("discrete.step", 0, 20), ("discrete.step", 24, 50),
            ("aten::mm", 1, 59)]
    device = [("k", 0, 10), ("k", 13, 20), ("k", 24, 30), ("k", 35, 50), ("k", 54, 58),
              ("k", 64, 70)]
    got = BENCH.reader("step_gap_us.vqofficial").read(_kernel_ctx(device, host))
    assert got == pytest.approx((3 + 5) / 2)
