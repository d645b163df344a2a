from .hybrid import (HybridStorage, MemoryCacheBackend, ParquetBackend,
                     StorageStats)  # noqa
