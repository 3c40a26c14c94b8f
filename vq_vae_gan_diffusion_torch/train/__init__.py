from ..config import CONTINUOUS_MODELS, TRANSFORMER_MODELS, VQ_STAGE1_MODELS
from .continuous_vq_worker import ContinuousVQDiffusionWorker
from .gaussian_diffusion_workers import GaussianDiffusion2DWorker, GaussianDiffusion3DWorker
from .vae_worker import VAEWorker
from .vq_diffusion_worker import VQDiffusionWorker
from .vq_transformer_worker import VQTransformerWorker
from .vqgan_worker import VQGANVQVAEWorker

# the workers whose OneCycle schedule takes the loader's batches an epoch
# (``num_iters_per_epoch``)
ONECYCLE_MODELS = ("vqdiffusion", "gaussiandiffusion3d")


def worker_class(model_name: str) -> type:
    """The worker that trains and serves ``architecture.model_name``."""
    if model_name in VQ_STAGE1_MODELS:
        return VQGANVQVAEWorker
    if model_name in TRANSFORMER_MODELS:
        return VQTransformerWorker
    if model_name in CONTINUOUS_MODELS:
        return ContinuousVQDiffusionWorker
    workers = {"vqdiffusion": VQDiffusionWorker, "gaussiandiffusion2d": GaussianDiffusion2DWorker,
               "gaussiandiffusion3d": GaussianDiffusion3DWorker, "vae": VAEWorker}
    if model_name not in workers:
        raise ValueError(f"no worker for model_name {model_name!r}")
    return workers[model_name]


__all__ = ["ContinuousVQDiffusionWorker", "GaussianDiffusion2DWorker", "GaussianDiffusion3DWorker",
           "ONECYCLE_MODELS", "VAEWorker", "VQDiffusionWorker", "VQTransformerWorker",
           "VQGANVQVAEWorker", "worker_class"]
