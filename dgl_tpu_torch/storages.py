"""FeatureStorage names (counterpart of ``dgl_tpu/storages.py``; reference
``python/dgl/storages/base.py:65``): aliases over the GraphBolt feature
stores.

``TensorStorage`` and ``NumpyStorage`` (reference
``storages/numpy_storage.py``) are both :class:`NumpyFeature`;
``DiskStorage`` is the out-of-core ``.npy`` store (the reference keeps that
role in GraphBolt's ``OnDiskNpyArray``)."""
from .graphbolt.feature_store import CachedFeature as CachedStorage
from .graphbolt.feature_store import DiskBasedFeature as DiskStorage
from .graphbolt.feature_store import Feature as FeatureStorage
from .graphbolt.feature_store import FeatureStore
from .graphbolt.feature_store import NumpyFeature as NumpyStorage
from .graphbolt.feature_store import NumpyFeature as TensorStorage

__all__ = [
    "FeatureStorage",
    "TensorStorage",
    "NumpyStorage",
    "DiskStorage",
    "CachedStorage",
    "FeatureStore",
]
