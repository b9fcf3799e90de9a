from .trainer import restore_pool

__all__ = ["restore_pool"]
