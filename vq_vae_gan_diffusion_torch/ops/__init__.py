from .gpt_decode import fused_decode_stack, pack_decode_params, reference_decode_stack

__all__ = ["fused_decode_stack", "pack_decode_params", "reference_decode_stack"]
