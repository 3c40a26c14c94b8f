from .vq_transformer_worker import VQTransformerWorker

__all__ = ["VQTransformerWorker"]
