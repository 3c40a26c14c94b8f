"""The program's spans and counters.

A span marks one layer boundary of a request or a train step in the
``torch.profiler`` trace, beside the kernels, copies and sets it issued and
on the profiler's one clock, so that an idle gap of the card can be
charged to the span the host was in. While no profiler runs, :func:`span`
returns one shared object that does nothing, so the spans cost a call and
no allocation. A span is opened only where it runs at most a few thousand
times a request, never around a kernel launch: the launch counters below
count those.

The counters stay where the work happens, as attributes of the function
that does it (``fused_decode_stack.launches``, ``hop.calls``, ...);
:func:`counts` reads all of them and :func:`reset_counts` sets them to 0.
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler

# Every span the program opens. The port serves one request at a time on
# one thread, so a request's spans are those nested under it in time.
SPANS = (
    "gpt.sample",          # models/mingpt.sample_tokens, the whole call
    "gpt.position",        # one position of sample_tokens's loop
    "gaussian3d.chain",    # GaussianDiffusion3D.ddpm_sample / ddim_sample
    "gaussian3d.step",     # one reverse step of either
    "gaussian3d.readout",  # VQGaussianDiffusion3D.gaussian_to_indices
    "discrete.chain",      # DiscreteDiffusion.sample / sample_fast
    "discrete.step",       # one reverse step of either, or of the transformer prior's fast_sample
    "vqgan.encode",        # models/vqvae.VQVAE.encode
    "vqgan.decode",        # models/vqvae.VQVAE.decode_indices
    "serve.request",       # ServingWorker._sample_and_decode
    "train.step",          # a prior worker's train_step
    "train.forward",       # its composite's forward and the loss
    "train.backward",      # zero_grad, backward, the gradients' reduction
    "train.optimizer",     # the lr / beta1 schedule, the step, the EMA
)


class _Off:
    """The span of a process with no profiler running: does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str):
    """A context that marks ``name`` (one of :data:`SPANS`) in the trace
    while a ``torch.profiler`` profile is active, and the shared no-op
    otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


# Every counter: a kernel wrapper's launches (and its bf16 instantiation's,
# where it counts them) by the kernel's name, a collective's calls.
_KERNELS = {
    "gpt_decode_stack": ("ops.gpt_decode", "fused_decode_stack"),
    "gpt_decode_stack_q": ("ops.gpt_decode", "fused_decode_stack_q"),
    "gpt_decode_stack_qkv": ("ops.gpt_decode", "fused_decode_stack_qkv"),
    "shuffle_bottleneck": ("ops.shuffle", "fused_bottleneck"),
    "shuffle_downsample": ("ops.shuffle", "fused_downsample"),
    "discrete_posterior": ("ops.discrete_posterior", "fused_posterior_sample"),
    "discrete_posterior_prng": ("ops.discrete_posterior", "fused_posterior_sample_prng"),
}
_COLLECTIVES = {
    "all_reduce_mean": ("parallel.mesh", "all_reduce_mean", "calls"),
    "all_gather_rows": ("parallel.mesh", "all_gather_rows", "calls"),
    "sync_batch_stats": ("parallel.mesh", "sync_batch_stats", "calls"),
    "sync_batch_stats_grad": ("parallel.mesh", "sync_batch_stats", "grad_calls"),
    "gather_tokens": ("parallel.sequence", "gather_tokens", "calls"),
    "gather_tokens_grad": ("parallel.sequence", "gather_tokens", "grad_calls"),
    "gather_logits": ("parallel.sequence", "gather_logits", "calls"),
    "hop": ("parallel.pipeline", "hop", "calls"),
    "hop_grad": ("parallel.pipeline", "hop", "grad_calls"),
}


def _function(mod: str, name: str):
    return getattr(importlib.import_module(f"..{mod}", __package__), name)


def _owners():
    """(group, key, the function that holds the counter, its attribute)."""
    for key, (mod, fn) in _KERNELS.items():
        f = _function(mod, fn)
        yield "launches", key, f, "launches"
        if hasattr(f, "bf16_launches"):
            yield "bf16_launches", key, f, "bf16_launches"
    for key, (mod, fn, attr) in _COLLECTIVES.items():
        yield "collectives", key, _function(mod, fn), attr


def counts() -> Dict[str, Dict[str, int]]:
    """Every counter of the program since the last :func:`reset_counts`:
    ``{"launches": {kernel: n}, "bf16_launches": {kernel: n},
    "collectives": {collective: n}}``."""
    out: Dict[str, Dict[str, int]] = {"launches": {}, "bf16_launches": {}, "collectives": {}}
    for group, key, f, attr in _owners():
        out[group][key] = getattr(f, attr)
    return out


def reset_counts() -> None:
    """Set every counter of :func:`counts` to 0."""
    for _, _, f, attr in _owners():
        setattr(f, attr, 0)
