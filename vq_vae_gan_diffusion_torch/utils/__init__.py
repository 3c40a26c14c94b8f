from .device import compute_autocast, resolve_device
from .experiment import MetricWriter, adaptive_save_step, create_run_dir, setup_logging
from .image import make_grid, psnr, save_gif, save_image, to_uint8

__all__ = ["compute_autocast", "resolve_device", "MetricWriter", "adaptive_save_step", "create_run_dir",
           "setup_logging", "make_grid", "psnr", "save_gif", "save_image", "to_uint8"]
