"""Each fault that a cell can have, planted under the timed path of a run
at tiny sizes on the CPU (the harness's look for a card skipped), turns
``correct`` false; the same run unbroken is correct. The cells have one
chip, so no exchange between chips can be left out."""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from port_bench.calibrate import half_batch
from port_bench.run import Bench, run_cell

from .tiny import tiny

SEED = 2 ** 32 + 17


def _run(cell: str):
    bench = Bench()
    cfg = tiny(bench.config(bench.cell(cell)["config"]))
    # long enough on a busy CPU for greedy requests (every fourth) and sampled ones
    return run_cell(bench, cell, SEED, 2.0, False, device="cpu", config=cfg)


@contextlib.contextmanager
def unchanged_state():
    """Each train step computes its loss and returns its state unchanged."""
    import vq_vae_gan_diffusion_torch.train.vq_diffusion_worker as vd
    import vq_vae_gan_diffusion_torch.train.vq_transformer_worker as vt

    def gpt_step(self, state, batch, generator=None, **draws):
        with torch.no_grad():
            logits, targets = self.composite(batch, generator, **draws)
        return state, {"ce_loss": F.cross_entropy(logits.flatten(0, 1), targets.flatten())}

    def diffusion_step(self, state, batch, generator=None, **draws):
        with torch.no_grad():
            loss, metrics, _ = self.composite.loss(batch, generator, **draws)
        return state, metrics

    saved = vt.VQTransformerWorker.train_step, vd.VQDiffusionWorker.train_step
    vt.VQTransformerWorker.train_step, vd.VQDiffusionWorker.train_step = gpt_step, diffusion_step
    try:
        yield
    finally:
        vt.VQTransformerWorker.train_step, vd.VQDiffusionWorker.train_step = saved


@contextlib.contextmanager
def altered_token():
    """The GPT's sampler returns the next token to each one it draws."""
    import vq_vae_gan_diffusion_torch.models.mingpt as mingpt

    draw = mingpt.categorical
    mingpt.categorical = lambda logits, *a, **k: (draw(logits, *a, **k) + 1) % logits.shape[-1]
    try:
        yield
    finally:
        mingpt.categorical = draw


@contextlib.contextmanager
def altered_sampled_token():
    """The GPT's sampler returns, in a sampled request only, the least
    likely token in place of each one it draws: a token outside the top k."""
    import vq_vae_gan_diffusion_torch.models.mingpt as mingpt

    draw = mingpt.categorical

    def worst(logits, *a, **k):
        sampled = bool((torch.isfinite(logits).sum(-1) > 1).all())   # greedy keeps one
        return logits.argmin(-1) if sampled else draw(logits, *a, **k)
    mingpt.categorical = worst
    try:
        yield
    finally:
        mingpt.categorical = draw


@contextlib.contextmanager
def altered_index():
    """The gaussian3d read-out returns the next index to each one it reads."""
    from vq_vae_gan_diffusion_torch.diffusion.gaussian3d import VQGaussianDiffusion3D as P

    read = P.gaussian_to_indices
    P.gaussian_to_indices = lambda self, g: (read(self, g) + 1) % self.vocab_size
    try:
        yield
    finally:
        P.gaussian_to_indices = read


FAULTS = [("gpt.train", "unchanged"), ("gpt.train", "half_batch"),
          ("gaussian3d.train", "unchanged"), ("gaussian3d.train", "half_batch"),
          ("gpt.serve", "altered"), ("gpt.serve", "altered_sampled"),
          ("gaussian3d.serve", "altered")]


@pytest.mark.parametrize("cell", ["gpt.serve", "gaussian3d.serve", "gpt.train",
                                  "gaussian3d.train"])
def test_an_unbroken_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"] is True, line["checks"]


def test_a_window_with_nothing_to_judge_is_not_correct():
    """A gpt.serve window that finished no request judged nothing."""
    bench = Bench()
    cfg = tiny(bench.config("gpt_flowers256"))
    fam = bench.family(cfg)
    checks = dict(fam.serve_check(cfg, SEED, [], torch.device("cpu")))
    assert checks == {"logit_gap": None, "topk_gap": None, "image_err": None}


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    if fault == "unchanged":
        ctx = unchanged_state()
    elif fault == "half_batch":
        ctx = half_batch()
    elif fault == "altered_sampled":
        ctx = altered_sampled_token()
    else:
        ctx = altered_token() if cell == "gpt.serve" else altered_index()
    with ctx:
        line = _run(cell)
    assert line["correct"] is False, line["checks"]
    if fault == "altered_sampled":
        # only the sampled requests' number can see it
        assert line["checks"]["topk_gap"]["value"] > line["checks"]["topk_gap"]["limit"]
        assert line["checks"]["logit_gap"]["value"] <= line["checks"]["logit_gap"]["limit"]
