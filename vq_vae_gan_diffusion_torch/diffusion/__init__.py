from .gaussian import GaussianSchedule, make_schedule
from .gaussian3d import GaussianDiffusion3D, VQGaussianDiffusion3D, positional_encoding_table

__all__ = ["GaussianSchedule", "make_schedule", "GaussianDiffusion3D",
           "VQGaussianDiffusion3D", "positional_encoding_table"]
