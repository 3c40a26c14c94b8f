from .mingpt import GPT, sample_tokens, top_k_filter
from .vq_transformer import VQTransformer
from .vqvae import VQVAE

__all__ = ["GPT", "sample_tokens", "top_k_filter", "VQTransformer", "VQVAE"]
