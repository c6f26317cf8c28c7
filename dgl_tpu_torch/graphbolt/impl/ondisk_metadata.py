"""OnDisk metadata schema (counterpart of
``dgl_tpu/graphbolt/impl/ondisk_metadata.py``; reference
``python/dgl/graphbolt/impl/ondisk_metadata.py`` — pydantic models there;
plain dataclasses here, same field names, with ``from_dict`` parsing)."""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

__all__ = [
    "ExtraMetaData",
    "OnDiskFeatureDataFormat",
    "OnDiskFeatureDataDomain",
    "OnDiskFeatureData",
    "OnDiskTVTSetData",
    "OnDiskTVTSet",
    "OnDiskGraphTopologyType",
    "OnDiskGraphTopology",
    "OnDiskTaskData",
    "OnDiskMetaData",
]


class ExtraMetaData:
    """Base carrying unrecognized keys in ``extra_fields`` (the pydantic
    ``extra='allow'`` behavior, reference ``ondisk_metadata.py:24``)."""

    def __init__(self, **kwargs):
        known = {f for f in getattr(self, "__dataclass_fields__", {})}
        self.extra_fields = {
            k: v for k, v in kwargs.items() if k not in known
        }


class OnDiskFeatureDataFormat(str, Enum):
    TORCH = "torch"
    NUMPY = "numpy"


class OnDiskFeatureDataDomain(str, Enum):
    NODE = "node"
    EDGE = "edge"
    GRAPH = "graph"


@dataclass
class OnDiskFeatureData:
    """(reference ``ondisk_metadata.py:88``)."""

    domain: OnDiskFeatureDataDomain
    name: str
    format: OnDiskFeatureDataFormat = OnDiskFeatureDataFormat.NUMPY
    path: Optional[str] = None
    type: Optional[str] = None
    in_memory: bool = True
    extra_fields: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OnDiskTVTSetData:
    """(reference ``ondisk_metadata.py:64``)."""

    format: OnDiskFeatureDataFormat = OnDiskFeatureDataFormat.NUMPY
    path: Optional[str] = None
    in_memory: bool = True
    type: Optional[str] = None


@dataclass
class OnDiskTVTSet:
    """(reference ``ondisk_metadata.py:73``)."""

    type: Optional[str] = None
    data: List[OnDiskTVTSetData] = field(default_factory=list)


class OnDiskGraphTopologyType(str, Enum):
    FUSED_CSC_SAMPLING = "FusedCSCSamplingGraph"


@dataclass
class OnDiskGraphTopology:
    """(reference ``ondisk_metadata.py:104``)."""

    type: OnDiskGraphTopologyType = (
        OnDiskGraphTopologyType.FUSED_CSC_SAMPLING
    )
    path: Optional[str] = None


@dataclass
class OnDiskTaskData:
    """(reference ``ondisk_metadata.py:111``)."""

    name: Optional[str] = None
    num_classes: Optional[int] = None
    train_set: List[OnDiskTVTSet] = field(default_factory=list)
    validation_set: List[OnDiskTVTSet] = field(default_factory=list)
    test_set: List[OnDiskTVTSet] = field(default_factory=list)
    extra_fields: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OnDiskMetaData:
    """(reference ``ondisk_metadata.py:119``)."""

    dataset_name: Optional[str] = None
    graph_topology: Optional[OnDiskGraphTopology] = None
    feature_data: List[OnDiskFeatureData] = field(default_factory=list)
    tasks: List[OnDiskTaskData] = field(default_factory=list)

    @staticmethod
    def from_dict(meta: Dict[str, Any]) -> "OnDiskMetaData":
        gt = meta.get("graph_topology")
        return OnDiskMetaData(
            dataset_name=meta.get("dataset_name"),
            graph_topology=(
                OnDiskGraphTopology(
                    type=OnDiskGraphTopologyType(
                        gt.get("type", "FusedCSCSamplingGraph")
                    ),
                    path=gt.get("path"),
                )
                if gt else None
            ),
            feature_data=[
                OnDiskFeatureData(
                    domain=OnDiskFeatureDataDomain(f.get("domain", "node")),
                    name=f["name"],
                    format=OnDiskFeatureDataFormat(
                        f.get("format", "numpy")
                    ),
                    path=f.get("path"),
                    type=f.get("type"),
                    in_memory=f.get("in_memory", True),
                )
                for f in meta.get("feature_data", [])
            ],
            tasks=[
                OnDiskTaskData(
                    name=t.get("name"),
                    num_classes=t.get("num_classes"),
                    train_set=_parse_tvt(t.get("train_set")),
                    validation_set=_parse_tvt(t.get("validation_set")),
                    test_set=_parse_tvt(t.get("test_set")),
                    extra_fields={
                        k: v for k, v in t.items()
                        if k not in (
                            "name", "num_classes", "train_set",
                            "validation_set", "test_set",
                        )
                    },
                )
                for t in meta.get("tasks", [])
            ],
        )


def _parse_tvt(entries) -> List[OnDiskTVTSet]:
    """Parse a task's train/validation/test_set list into OnDiskTVTSet
    objects (each entry: {type, data: [{format, path, in_memory, type}]})."""
    out = []
    for e in entries or []:
        out.append(OnDiskTVTSet(
            type=e.get("type"),
            data=[
                OnDiskTVTSetData(
                    format=OnDiskFeatureDataFormat(
                        d.get("format", "numpy")
                    ),
                    path=d.get("path"),
                    in_memory=d.get("in_memory", True),
                    type=d.get("type"),
                )
                for d in e.get("data", [])
            ],
        ))
    return out
