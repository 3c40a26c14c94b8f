"""Tiny copies of the benchmark's configurations, for the CPU tests: every
width cut, the structure (blocks, attention, units, the schedule) kept."""

import copy


def tiny(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg.update(img_size=16, batch_size=4)
    cfg["vqvae"].update(latent_channels=8, latent_size=4, intermediate_channels=[8, 8, 16],
                        attention_resolution=[4], num_codebook_vectors=32)
    if "vqvae_transformer" in cfg:
        cfg["vqvae_transformer"].update(n_layer=2, n_head=2, n_embd=32, block_size=32)
    if "vqdiffusion" in cfg:
        cfg["vqdiffusion"].update(diffusion_steps=10, sampling_steps=10, gaussian_dim=8)
        cfg["unet"].update(base_dim=8, dim_mults=[1, 2])
    if "serve" in cfg:
        cfg["serve"].update(top_k=8)    # below the tiny codebook's 32 codes
    return cfg

