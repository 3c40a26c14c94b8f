"""PatchGAN discriminator (PyTorch counterpart of the JAX ``models/discriminator.py``).

4x4 convolutions, channels 64 -> 128 -> 256 -> 512: ``conv0`` stride 2 with a
bias and LeakyReLU(0.2); three bias-free convs of strides 2, 2, 1, each
followed by BatchNorm and LeakyReLU(0.2); a last conv to one logit map. At
28x28 the output is [B, 1, 1, 1]. Inputs and outputs are NHWC, as the JAX
module's; the convolutions run NCHW.

The modules sit in one ``nn.Sequential`` named ``model`` at the reference's
indices (``model.0``, ``model.2/3``, ``model.5/6``, ``model.8/9``,
``model.11``), the names ``utils/torch_export.export_discriminator`` of the
JAX package writes.

BatchNorm as the JAX step runs it (flax ``train=True``), not as
``nn.BatchNorm2d.forward`` does:

- it normalises with the batch statistics (eps 1e-5); the running ones are
  kept for the checkpoint's sake, as the JAX package keeps them;
- the running statistics move only when the caller asks
  (``update_stats=True``): the JAX step also runs the discriminator on
  batch statistics in calls that leave them as they are (the generator's
  ``D(G(x))``, from which the adaptive lambda's gradient is taken too);
- the update is flax's ``momentum=0.9`` (torch's 0.1) with the *biased*
  batch variance, where ``nn.BatchNorm2d`` would take the unbiased one;
- under a process group the statistics are the global batch's, as the JAX
  step over a ``data``-sharded batch takes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import batch_norm_train
from .blocks import at_least_f32

MOMENTUM = 0.9      # flax's: running = MOMENTUM * running + (1 - MOMENTUM) * batch
EPS = 1e-5


class Discriminator(nn.Module):
    def __init__(self, img_channels: int = 3, num_filters_last: int = 64, n_layers: int = 3):
        super().__init__()
        layers: list[nn.Module] = [
            nn.Conv2d(img_channels, num_filters_last, 4, 2, 1), nn.LeakyReLU(0.2)]
        cin = num_filters_last
        for i in range(1, n_layers + 1):
            cout = num_filters_last * min(2 ** i, 8)
            layers += [nn.Conv2d(cin, cout, 4, 2 if i < n_layers else 1, 1, bias=False),
                       nn.BatchNorm2d(cout, eps=EPS, momentum=1 - MOMENTUM),
                       nn.LeakyReLU(0.2)]
            cin = cout
        layers.append(nn.Conv2d(cin, 1, 4, 1, 1))
        self.model = nn.Sequential(*layers)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's init, drawn from ``generator``: conv weights
        N(0, 0.02), BatchNorm scales N(1, 0.02), biases 0, running mean 0
        and variance 1."""
        for m in self.model:
            if isinstance(m, nn.Conv2d):
                nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.normal_(m.weight, 1.0, 0.02, generator=generator)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()

    def forward(self, x: torch.Tensor, *, update_stats: bool = False) -> torch.Tensor:
        """x [B, H, W, C] -> logits [B, h, w, 1], on batch statistics."""
        h = x.permute(0, 3, 1, 2)
        for m in self.model:
            h = _batch_norm(m, h, update_stats) if isinstance(m, nn.BatchNorm2d) else m(h)
        return h.permute(0, 2, 3, 1)


def _batch_norm(bn: nn.BatchNorm2d, h: torch.Tensor, update_stats: bool) -> torch.Tensor:
    """Train-mode BatchNorm in f32 (flax's statistics and arithmetic), over
    the global batch under a process group (:func:`..parallel.batch_norm_train`)."""
    out = batch_norm_train(at_least_f32(h), bn, 1 - MOMENTUM if update_stats else None)
    return out.to(h.dtype)
