from .device import resolve_device
from .experiment import MetricWriter, adaptive_save_step, create_run_dir, setup_logging
from .image import make_grid, save_gif, save_image, to_uint8

__all__ = ["resolve_device", "MetricWriter", "adaptive_save_step", "create_run_dir",
           "setup_logging", "make_grid", "save_gif", "save_image", "to_uint8"]
