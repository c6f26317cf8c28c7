"""Global configuration (counterpart of ``dgl_tpu/config.py``; reference
``python/dgl/global_config.py`` and the environment variables of
``docs/source/env_var.rst``, in one dataclass with environment overrides).

The fields and variables are the JAX package's. No module of either
package reads them."""
from __future__ import annotations

import os
from dataclasses import dataclass, field

__all__ = ["Config", "config", "get_config"]


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() not in ("0", "false", "no", "")


@dataclass
class Config:
    # sampling / dataloading
    use_native: bool = field(
        default_factory=lambda: not _env_bool("DGL_TPU_NO_NATIVE", False)
    )
    num_prefetch: int = field(
        default_factory=lambda: int(os.environ.get("DGL_TPU_PREFETCH", "2"))
    )
    # dataset
    download_dir: str = field(
        default_factory=lambda: os.environ.get(
            "DGL_TPU_DOWNLOAD_DIR",
            os.path.join(os.path.expanduser("~"), ".dgl_tpu"),
        )
    )
    # logging
    debug: bool = field(
        default_factory=lambda: _env_bool("DGL_TPU_LOG_DEBUG", False)
    )
    # kernels
    pad_multiple: int = field(
        default_factory=lambda: int(os.environ.get("DGL_TPU_PAD_MULTIPLE", "8"))
    )


config = Config()


def get_config() -> Config:
    return config
