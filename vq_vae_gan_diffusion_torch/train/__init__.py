from .continuous_vq_worker import ContinuousVQDiffusionWorker
from .gaussian_diffusion_workers import GaussianDiffusion2DWorker, GaussianDiffusion3DWorker
from .vae_worker import VAEWorker
from .vq_diffusion_worker import VQDiffusionWorker
from .vq_transformer_worker import VQTransformerWorker
from .vqgan_worker import VQGANVQVAEWorker

__all__ = ["ContinuousVQDiffusionWorker", "GaussianDiffusion2DWorker", "GaussianDiffusion3DWorker",
           "VAEWorker", "VQDiffusionWorker", "VQTransformerWorker", "VQGANVQVAEWorker"]
