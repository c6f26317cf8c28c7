"""Dataset base class (counterpart of ``dgl_tpu/data/dgl_dataset.py``;
reference ``python/dgl/data/dgl_dataset.py``).

Lifecycle identical to the reference: ``has_cache -> load`` else
``download -> process -> save``. Raw/processed dirs default to
``~/.dgl_tpu`` (env ``DGL_TPU_DOWNLOAD_DIR``), the JAX package's, so a
cache written by either package loads in the other. A dataset's graphs
and frames lie on ``device`` (``"cuda"`` unless the caller asks for the
CPU), set before ``process()`` runs inside the constructor.
"""
from __future__ import annotations

import hashlib
import os
import tarfile
import urllib.request
import zipfile
from typing import Optional

import torch

from ..base import DGLError

__all__ = ["DGLDataset", "download", "extract_archive", "get_download_dir"]


def get_download_dir() -> str:
    d = os.environ.get(
        "DGL_TPU_DOWNLOAD_DIR", os.path.join(os.path.expanduser("~"), ".dgl_tpu")
    )
    os.makedirs(d, exist_ok=True)
    return d


def download(url: str, path: str, overwrite: bool = False, retries: int = 2) -> str:
    """Fetch a URL to ``path`` (reference ``data/utils.py`` ``download``).

    Raises DGLError with a clear message when the environment has no
    network egress.
    """
    if os.path.exists(path) and not overwrite:
        return path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    last = None
    for _ in range(retries):
        try:
            urllib.request.urlretrieve(url, path)
            return path
        except Exception as e:  # pragma: no cover - network-dependent
            last = e
    raise DGLError(
        f"Failed to download {url}: {last}. This environment may have no "
        "network egress; use the dataset's synthetic=True fallback or "
        "pre-populate the raw_dir."
    )


def extract_archive(file_path: str, target_dir: str, overwrite: bool = False):
    """(reference ``data/utils.py`` ``extract_archive``)."""
    if os.path.exists(target_dir) and not overwrite:
        return
    os.makedirs(target_dir, exist_ok=True)
    if tarfile.is_tarfile(file_path):
        with tarfile.open(file_path) as f:
            f.extractall(target_dir)
    elif zipfile.is_zipfile(file_path):
        with zipfile.ZipFile(file_path) as f:
            f.extractall(target_dir)
    else:
        raise DGLError(f"Unknown archive format: {file_path}")


class DGLDataset:
    """Base dataset (reference ``dgl_dataset.py:28``).

    Subclasses implement ``process``; optionally ``download``, ``save``,
    ``load``, ``has_cache``, ``__getitem__``, ``__len__``.
    """

    def __init__(
        self,
        name: str,
        url: Optional[str] = None,
        raw_dir: Optional[str] = None,
        save_dir: Optional[str] = None,
        hash_key=(),
        force_reload: bool = False,
        verbose: bool = False,
        transform=None,
        device="cuda",
    ):
        self._device = torch.device(device)
        self._name = name
        self._url = url
        self._force_reload = force_reload
        self._verbose = verbose
        self._transform = transform
        self._hash_key = hash_key
        self._hash = self._get_hash()
        self._raw_dir = raw_dir or get_download_dir()
        self._save_dir = save_dir or self._raw_dir
        self._load()

    # -- lifecycle ----------------------------------------------------------

    def download(self):
        pass

    def process(self):
        raise NotImplementedError

    def save(self):
        pass

    def load(self):
        pass

    def has_cache(self) -> bool:
        return False

    def _load(self):
        if not self._force_reload and self.has_cache():
            self.load()
            if self._verbose:
                print(f"Done loading data from cached files for {self.name}.")
            return
        self._download()
        self.process()
        self.save()
        if self._verbose:
            print(f"Done saving data into cached files for {self.name}.")

    def _download(self):
        if self._url is None:
            return
        os.makedirs(self.raw_dir, exist_ok=True)
        self.download()

    def _get_hash(self):
        m = hashlib.sha1()
        m.update(str(self._hash_key).encode("utf-8"))
        return m.hexdigest()[:8]

    # -- properties ----------------------------------------------------------

    @property
    def name(self):
        return self._name

    @property
    def url(self):
        return self._url

    @property
    def raw_dir(self):
        return os.path.join(self._raw_dir, self.name)

    @property
    def raw_path(self):
        return self.raw_dir

    @property
    def save_dir(self):
        return self._save_dir

    @property
    def save_path(self):
        return os.path.join(self._save_dir, self.name)

    @property
    def verbose(self):
        return self._verbose

    @property
    def hash(self):
        return self._hash

    @property
    def device(self) -> torch.device:
        return self._device

    def _apply_transform(self, g):
        return self._transform(g) if self._transform is not None else g

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def __repr__(self):
        return (
            f'Dataset("{self.name}", num_graphs={len(self)},'
            f" save_path={self.save_path})"
        )
