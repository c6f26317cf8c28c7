"""On-disk io helpers (counterpart of ``dgl_tpu/graphbolt/internal_utils.py``;
reference ``python/dgl/graphbolt/internal/utils.py`` and
``internal_utils.py``): array read/write, hashing, archives.

``download`` only returns a file that is already in place: datasets come
from directories prepared beforehand.
"""
from __future__ import annotations

import hashlib
import os
import tarfile
import zipfile
from typing import Optional

import numpy as np

from ..graph import _asnumpy

__all__ = [
    "numpy_save_aligned",
    "read_data",
    "save_data",
    "get_npy_dim",
    "copy_or_convert_data",
    "read_edges",
    "calculate_file_hash",
    "calculate_dir_hash",
    "check_dataset_change",
    "check_sha1",
    "extract_archive",
    "download",
]


def numpy_save_aligned(file, array, page_size: int = 4096):
    """np.save with the header padded so the array data starts on a page
    boundary (reference ``internal/utils.py:15`` — required for O_DIRECT
    io_uring reads; here it keeps mmap reads page-aligned)."""
    array = np.asarray(array)
    if isinstance(file, str) and not file.endswith(".npy"):
        file = file + ".npy"
    with open(file, "wb") as f:
        header = np.lib.format.header_data_from_array_1_0(array)
        # grow the header to the next page boundary using spare padding
        np.lib.format._write_array_header(  # noqa: SLF001 - numpy format API
            f, header, version=(1, 0)
        )
        pos = f.tell()
        pad = (-pos) % page_size
        if pad:
            # rewrite with extra spaces in the header padding area
            f.seek(0)
            f.truncate()
            import io

            buf = io.BytesIO()
            np.lib.format._write_array_header(buf, header, version=(1, 0))
            raw = bytearray(buf.getvalue())
            # header ends with '\n'; inject spaces before it
            insert = b" " * pad
            raw = raw[:-1] + insert + b"\n"
            # fix the little-endian header-length field (bytes 8:10)
            hlen = len(raw) - 10
            raw[8:10] = hlen.to_bytes(2, "little")
            f.write(raw)
        array.tofile(f)
    return file


def read_data(path: str, fmt: str, in_memory: bool = True):
    """Load an array file (reference ``internal/utils.py:40``); fmt in
    {'numpy', 'torch'}."""
    if fmt == "numpy":
        arr = np.load(path, mmap_mode=None if in_memory else "r")
        return arr if in_memory else arr
    if fmt == "torch":
        import torch

        return torch.load(path, weights_only=False)
    if fmt == "parquet":
        from .impl.feature_stores import ParquetFeature

        return ParquetFeature(path).read()
    raise ValueError(f"unsupported format {fmt!r}")


def save_data(data, path: str, fmt: str):
    """Save an array (reference ``internal/utils.py:50``)."""
    if fmt == "numpy":
        np.save(path, _asnumpy(data))
        return
    if fmt == "torch":
        import torch

        torch.save(data, path)
        return
    if fmt == "parquet":
        from .impl.feature_stores import ParquetFeature

        ParquetFeature.write(path, _asnumpy(data))
        return
    raise ValueError(f"unsupported format {fmt!r}")


def get_npy_dim(npy_path: str) -> int:
    """ndim of an .npy without loading it (reference
    ``internal/utils.py:83``)."""
    with open(npy_path, "rb") as f:
        version = np.lib.format.read_magic(f)
        shape, _, _ = np.lib.format._read_array_header(  # noqa: SLF001
            f, version
        )
    return len(shape)


def copy_or_convert_data(input_path: str, output_path: str,
                         input_format: str, output_format: str = "numpy",
                         in_memory: bool = True, is_feature: bool = False,
                         within_int32: bool = False):
    """Normalize a raw array file into the processed directory (reference
    ``internal/utils.py:114``)."""
    data = read_data(input_path, input_format, in_memory)
    if input_format == "torch":
        data = data.numpy()
    data = _asnumpy(data)
    if within_int32 and not is_feature:
        data = data.astype(np.int32)
    if not is_feature and data.ndim == 2 and data.shape[1] == 1:
        data = data[:, 0]
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    save_data(data, output_path, output_format)


def read_edges(dataset_dir: str, edge_fmt: str, edge_path: str):
    """(src, dst) from a csv or numpy edge file (reference
    ``internal/utils.py:147``)."""
    path = os.path.join(dataset_dir, edge_path)
    if edge_fmt == "csv":
        import pandas as pd

        df = pd.read_csv(path, names=["src", "dst"])
        return df["src"].to_numpy(), df["dst"].to_numpy()
    if edge_fmt == "numpy":
        arr = np.load(path)
        assert arr.ndim == 2 and arr.shape[0] == 2, \
            "numpy edges must be (2, E)"
        return arr[0], arr[1]
    if edge_fmt == "parquet":
        import pyarrow.parquet as pq

        table = pq.read_table(path, memory_map=True)
        return (
            np.asarray(table.column("src").combine_chunks()),
            np.asarray(table.column("dst").combine_chunks()),
        )
    raise ValueError(f"unsupported edge format {edge_fmt!r}")


def calculate_file_hash(file_path: str, hash_algo: str = "md5") -> str:
    """(reference ``internal/utils.py:171``)."""
    h = hashlib.new(hash_algo)
    with open(file_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def calculate_dir_hash(dir_path: str, hash_algo: str = "md5",
                       ignore: Optional[list] = None) -> dict:
    """Per-file hashes of a directory tree (reference
    ``internal/utils.py:186``)."""
    ignore = set(ignore or [])
    hashes = {}
    for root, _, files in os.walk(dir_path):
        for fname in files:
            if fname in ignore:
                continue
            p = os.path.join(root, fname)
            hashes[os.path.relpath(p, dir_path)] = calculate_file_hash(p)
    return hashes


def check_dataset_change(dataset_dir: str, processed_dir: str) -> bool:
    """True if the raw dataset changed since preprocessing (reference
    ``internal/utils.py:201``): compares the stored hash record."""
    import json

    record = os.path.join(dataset_dir, processed_dir, "dataset_hash.json")
    if not os.path.exists(record):
        return True
    with open(record) as f:
        stored = json.load(f)
    current = calculate_dir_hash(
        dataset_dir, ignore=["dataset_hash.json"]
    )
    current = {
        k: v for k, v in current.items() if not k.startswith(processed_dir)
    }
    return stored != current


def check_sha1(filename: str, sha1_hash: str) -> bool:
    """(reference ``internal_utils.py:288``)."""
    h = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest() == sha1_hash


def extract_archive(file: str, target_dir: str, overwrite: bool = True):
    """Unpack .zip/.tar(.gz) (reference ``internal_utils.py:316``)."""
    os.makedirs(target_dir, exist_ok=True)
    if file.endswith(".zip"):
        with zipfile.ZipFile(file) as z:
            z.extractall(target_dir)
        return
    if file.endswith((".tar", ".tar.gz", ".tgz", ".gz")):
        with tarfile.open(file) as t:
            t.extractall(target_dir)
        return
    raise ValueError(f"unrecognized archive {file!r}")


def download(url: str, path: Optional[str] = None, overwrite: bool = True,
             sha1_hash: Optional[str] = None, retries: int = 5,
             verify_ssl: bool = True, log: bool = True):
    """Reference ``internal_utils.py:180``, without the network: a target
    already in place is returned (its sha1 checked when given); otherwise
    the error says where to put the file."""
    fname = path or url.split("/")[-1]
    if os.path.isdir(fname):
        fname = os.path.join(fname, url.split("/")[-1])
    if os.path.exists(fname):
        if sha1_hash and not check_sha1(fname, sha1_hash):
            raise RuntimeError(f"{fname} exists but sha1 mismatch")
        return fname
    raise RuntimeError(
        f"cannot download {url!r}: this build does not fetch files. "
        f"Place the file at {fname!r} and retry."
    )
