"""The port's spans and counters (``utils/tracing.py``) and the benchmark's
readers of the idle gaps under the spans (``port_bench/metrics/
span_idle.py``), on the CPU at tiny sizes: the spans cost nothing without
a profiler, nest as the layers do in a ``torch.profiler`` trace, and
every span the package opens is named in ``SPANS``."""

import ast
from pathlib import Path

import pytest
import torch

from port_bench import trace as bench_trace
from port_bench.families import gaussian3d as g3d_family
from port_bench.families import gpt as gpt_family
from port_bench.metrics import span_idle
from port_bench.run import Bench
from port_bench.tests.tiny import tiny
from vq_vae_gan_diffusion_torch.diffusion.discrete import DiscreteDiffusion
from vq_vae_gan_diffusion_torch.diffusion.gaussian3d import GaussianDiffusion3D
from vq_vae_gan_diffusion_torch.models.mingpt import GPT, sample_tokens
from vq_vae_gan_diffusion_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]


def _spans(prof) -> list:
    """The program's spans of a finished profile, in order of start."""
    host = bench_trace.read(prof)["host"]
    return sorted((s for s in host if s[0] in tracing.SPANS), key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_the_shared_no_op_without_a_profiler():
    first = tracing.span("gpt.position")
    assert first is tracing.span("train.step")
    assert not isinstance(first, torch.profiler.record_function)
    with first as entered:
        assert entered is None


def test_sample_tokens_gives_one_sample_span_holding_a_span_a_position():
    torch.manual_seed(0)
    gpt = GPT(vocab_size=16, block_size=8, n_layer=1, n_head=2, n_embd=8).eval()
    prefix = torch.zeros((2, 1), dtype=torch.long)
    with bench_trace.profiler() as prof:
        sample_tokens(gpt, prefix, 1, 6, top_k=4)
    spans = _spans(prof)
    (sample,) = [s for s in spans if s[0] == "gpt.sample"]
    positions = [s for s in spans if s[0] == "gpt.position"]
    assert len(positions) == 6 and all(_inside(p, sample) for p in positions)


def test_ddpm_sample_gives_one_chain_span_holding_a_span_a_step():
    diffusion = GaussianDiffusion3D((4, 2), 1, 5, 5, lambda x, c, t: 0.1 * x, "noise_mse",
                                    "ddpm")
    with bench_trace.profiler() as prof:
        diffusion.ddpm_sample(2, generator=torch.Generator().manual_seed(0))
    spans = _spans(prof)
    (chain,) = [s for s in spans if s[0] == "gaussian3d.chain"]
    steps = [s for s in spans if s[0] == "gaussian3d.step"]
    assert len(steps) == 5 and all(_inside(s, chain) for s in steps)


def _discrete_chain(kind: str, steps: int):
    """A tiny discrete chain of ``steps`` reverse steps: VQ_Official's
    ``sample`` or ``sample_fast``, or the transformer prior's
    ``fast_sample``."""
    if kind == "transformer":
        from vq_vae_gan_diffusion_torch.models.transformer_vq_diffusion import (
            TransformerVQDiffusion)

        torch.manual_seed(0)
        prior = TransformerVQDiffusion(codebook_size=8, seq_len=4,
                                       diffusion_steps=2 * steps - 1, embedding_dim=8,
                                       num_layers=1, num_heads=2)
        return lambda: prior.fast_sample(2, skip_step=2,
                                         generator=torch.Generator().manual_seed(0))
    d = DiscreteDiffusion(num_classes=9, seq_len=4, timesteps=steps)
    d.model_fn = lambda log_x, t: 0.1 * log_x[..., :-1]
    g = torch.Generator().manual_seed(0)
    if kind == "sample":
        return lambda: d.sample(2, generator=g)
    return lambda: d.sample_fast(2, skip_step=0, generator=g)


@pytest.mark.parametrize("kind", ["sample", "sample_fast", "transformer"])
def test_a_discrete_chain_gives_one_chain_span_holding_a_span_a_step(kind, monkeypatch):
    steps = 5
    chain = _discrete_chain(kind, steps)
    with bench_trace.profiler() as prof:
        chain()
    spans = _spans(prof)
    (outer,) = [s for s in spans if s[0] == "discrete.chain"]
    inner = [s for s in spans if s[0] == "discrete.step"]
    assert len(inner) == steps and all(_inside(s, outer) for s in inner)
    # without a profiler every span the chain opens is the shared no-op
    opened = []
    span = tracing.span
    monkeypatch.setattr(tracing, "span", lambda name: opened.append((name, span(name))) or
                        opened[-1][1])
    chain()
    assert [name for name, _ in opened] == ["discrete.chain"] + ["discrete.step"] * steps
    assert all(ctx is span("gpt.position") for _, ctx in opened)


@pytest.mark.parametrize("family", [gpt_family, g3d_family], ids=["gpt", "gaussian3d"])
def test_a_train_step_gives_its_phases_in_order(family):
    cfg = Bench().config(f"{family.__name__.rsplit('.', 1)[1]}_flowers256")
    side = family.train_setup(tiny(cfg), {"batch": 2}, 5, torch.device("cpu"))
    with bench_trace.profiler() as prof:
        family.train_step(side, 0)
    spans = _spans(prof)
    names = [s[0] for s in spans if s[0] != "gaussian3d.readout"]
    assert names == ["train.step", "train.forward", "vqgan.encode", "train.backward",
                     "train.optimizer"]
    step, forward, encode, backward, optimizer = [s for s in spans if s[0] in names]
    assert all(_inside(s, step) for s in (forward, backward, optimizer))
    assert _inside(encode, forward)
    assert forward[2] <= backward[1] and backward[2] <= optimizer[1]
    # the gaussian3d loss reads its predicted indices out inside the forward
    assert all(_inside(s, forward) for s in spans if s[0] == "gaussian3d.readout")


def _span_calls(path: Path) -> list:
    """The first arguments of the ``tracing.span(...)`` calls in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "span" and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "tracing"):
            arg = node.args[0]
            out.append(arg.value if isinstance(arg, ast.Constant) else ast.dump(arg))
    return out


def test_every_span_opened_is_named_in_spans_and_every_name_is_opened():
    used = [name for path in sorted((ROOT / "vq_vae_gan_diffusion_torch").rglob("*.py"))
            for name in _span_calls(path)]
    assert set(used) <= set(tracing.SPANS), set(used) - set(tracing.SPANS)
    assert set(used) == set(tracing.SPANS)
    # the discrete chain's spans came after the harness's written-out list;
    # the vqofficial step reader names discrete.step itself
    assert set(tracing.SPANS) - set(span_idle.SPANS) == {"discrete.chain", "discrete.step"}
    assert set(span_idle.SPANS) < set(tracing.SPANS)
    assert Bench().reader("step_gap_us.vqofficial").SPAN == "discrete.step"


def test_counts_reads_and_reset_counts_clears_every_counter():
    from vq_vae_gan_diffusion_torch.ops.gpt_decode import fused_decode_stack
    from vq_vae_gan_diffusion_torch.parallel.pipeline import hop

    saved = fused_decode_stack.launches, fused_decode_stack.bf16_launches, hop.grad_calls
    try:
        fused_decode_stack.launches, fused_decode_stack.bf16_launches, hop.grad_calls = 3, 2, 1
        got = tracing.counts()
        assert got["launches"]["gpt_decode_stack"] == 3
        assert got["bf16_launches"]["gpt_decode_stack"] == 2
        assert got["collectives"]["hop_grad"] == 1
        assert "gpt_decode_stack_q" in got["launches"]
        assert "gpt_decode_stack_q" not in got["bf16_launches"]   # it counts no bf16 launches
        tracing.reset_counts()
        assert not any(v for group in tracing.counts().values() for v in group.values())
    finally:
        fused_decode_stack.launches, fused_decode_stack.bf16_launches, hop.grad_calls = saved


# Hand-built traces, times in us. Two train steps: the gaps' middles fall
# under encode (6.5, 111), forward (22), backward (41, 55), optimizer (77.5,
# 95, 193) and under no span (204.5); aten::mm covers most of the first
# step and is no program span.
TRAIN_HOST = [("train.step", 0, 100), ("train.forward", 0, 40), ("vqgan.encode", 0, 20),
              ("aten::mm", 10, 90), ("train.backward", 40, 70), ("train.optimizer", 70, 100),
              ("train.step", 100, 200), ("train.forward", 100, 150),
              ("vqgan.encode", 100, 120), ("train.backward", 150, 180),
              ("train.optimizer", 180, 200)]
TRAIN_DEVICE = [("k", 0, 5), ("k", 8, 12), ("k", 12, 14), ("k", 30, 35), ("k", 47, 50),
                ("k", 60, 75), ("k", 80, 85), ("k", 105, 110), ("k", 112, 190),
                ("k", 196, 199), ("k", 210, 215)]
SERVE_HOST = [("gpt.sample", 0, 100), ("gpt.position", 0, 50), ("gpt.position", 50, 100),
              ("aten::addmm", 5, 95)]
SERVE_DEVICE = [("k", 0, 10), ("k", 20, 60), ("k", 70, 100), ("k", 110, 120)]


def _ctx(host, device):
    return {"trace": {"kernels": device, "device": device, "host": host}}


def test_span_idle_charges_each_gap_to_the_spans_over_its_middle():
    trace = _ctx(TRAIN_HOST, TRAIN_DEVICE)["trace"]
    got = {k: round(v * 1e6, 9) for k, v in span_idle.gaps(trace).items()}
    step, fwd = ("train.step",), ("train.step", "train.forward")
    assert got == {fwd + ("vqgan.encode",): 5.0, fwd: 16.0, step + ("train.backward",): 22.0,
                   step + ("train.optimizer",): 31.0, (): 11.0}
    # the gaps are those of the breakdown, whatever they are charged to
    idle = bench_trace.breakdown(trace)["idle_gaps"]
    assert sum(v for _, v in idle) == pytest.approx(sum(span_idle.gaps(trace).values()))


@pytest.mark.parametrize("metric, want", [
    ("encode_gap_ms.train", 5.0 / 2 / 1e3), ("forward_gap_ms.train", 16.0 / 2 / 1e3),
    ("backward_gap_ms.train", 22.0 / 2 / 1e3), ("optimizer_gap_ms.train", 31.0 / 2 / 1e3),
    ("position_gap_us.gpt", 20.0 / 2), ("step_gap_us.gaussian3d", None)])
def test_the_readers_sum_the_gaps_a_unit(metric, want):
    reader = Bench().reader(metric)
    serve = metric.endswith((".gpt", ".gaussian3d"))
    ctx = _ctx(SERVE_HOST, SERVE_DEVICE) if serve else _ctx(TRAIN_HOST, TRAIN_DEVICE)
    got = reader.read(ctx)
    assert got == (None if want is None else pytest.approx(want))
    # a trace without the unit's spans, and no trace, read nothing
    other = _ctx(TRAIN_HOST, TRAIN_DEVICE) if serve else _ctx(SERVE_HOST, SERVE_DEVICE)
    assert reader.read(other) is None
    assert reader.read({"trace": None}) is None
