from .cache import LruCache

__all__ = ["LruCache"]
