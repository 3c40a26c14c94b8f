"""On the card, at vqofficial.serve's own size: one request of 4 images
runs the whole chain through the port's kernels (39,000 K1, 4,000 K2 and
999 B6 launches by the launch counters); the check keeps the program's
readings to their limits; the control (the plain reference in TF32 in the
program's place) fails ``logit_gap`` and ``image_err`` (TF32 flips no
pick, so ``pick_gap`` reads 0 for it); B6 sampling a step late fails
``pick_gap``. Run on the chip with ``python3 -m pytest port_bench/tests -m
card -rA`` (the readings print among the passes); skips elsewhere."""

import pytest

from port_bench.run import Bench

from .vqofficial_faults import late_step

SEED = 4100000011


@pytest.mark.card
def test_a_request_runs_the_kernels_and_the_check_judges_it(card):
    from vq_vae_gan_diffusion_torch.utils import tracing

    bench = Bench()
    cfg = bench.config("vqofficial_flowers256")
    fam, limits = bench.family(cfg), cfg["limits"]
    side = fam.serve_setup(cfg, {}, SEED, card)
    tracing.reset_counts()
    film = fam.serve_sample(side, 4, {"i": 0})
    launches = {k: v for k, v in tracing.counts()["launches"].items() if v}
    assert launches == {"shuffle_bottleneck": 39000, "shuffle_downsample": 4000,
                        "discrete_posterior": 999}
    kept = [{"i": 0, "codes": film, "images": fam.serve_decode(side, film)}]
    sound = dict(fam.serve_check(cfg, SEED, kept, card))
    control = dict(fam.serve_check(cfg, SEED, kept, card, control=True))
    with late_step():
        late = fam.serve_sample(side, 4, {"i": 1})
    fault = dict(fam.serve_check(cfg, SEED, [{"i": 1, "codes": late,
                                              "images": fam.serve_decode(side, late)}], card))
    print("vqofficial.serve", SEED, {"sound": sound, "control": control, "late_step": fault})
    assert all(sound[k] <= limits[k] for k in limits), sound
    assert control["logit_gap"] > limits["logit_gap"] and \
        control["image_err"] > limits["image_err"], control
    assert fault["pick_gap"] > limits["pick_gap"], fault
