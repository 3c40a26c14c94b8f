from .vq_diffusion_worker import VQDiffusionWorker
from .vq_transformer_worker import VQTransformerWorker

__all__ = ["VQDiffusionWorker", "VQTransformerWorker"]
