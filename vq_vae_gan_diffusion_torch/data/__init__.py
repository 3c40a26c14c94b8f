from .pipeline import DataLoader, load_dataloader

__all__ = ["DataLoader", "load_dataloader"]
