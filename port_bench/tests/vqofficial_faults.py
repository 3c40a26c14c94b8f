"""Faults planted in the port's VQ_Official chain, for the tests of the
``vqofficial`` family's check: each is a context that patches the port and
restores it."""

import contextlib


@contextlib.contextmanager
def late_step():
    """Every structured step's posterior coefficients taken at t + 1, so
    kernel B6 samples from the wrong step's posterior."""
    from vq_vae_gan_diffusion_torch.diffusion import discrete as td

    gather = td.gather_posterior_coefs
    td.gather_posterior_coefs = lambda sched, t, T: gather(sched, (t + 1).clamp(max=T - 1), T)
    try:
        yield
    finally:
        td.gather_posterior_coefs = gather


@contextlib.contextmanager
def pad_dropped():
    """x̂_0's mask row at log 1 where the port pads it with -70 (the dense
    first step and the check's reading of the program)."""
    from vq_vae_gan_diffusion_torch.diffusion import discrete as td

    pad = td.DiscreteDiffusion._log_pred_from_logits

    def dropped(self, out):
        x = pad(self, out).clone()
        x[..., -1] = 0.0
        return x
    td.DiscreteDiffusion._log_pred_from_logits = dropped
    try:
        yield
    finally:
        td.DiscreteDiffusion._log_pred_from_logits = pad
