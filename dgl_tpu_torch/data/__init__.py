"""Dataset zoo (counterpart of ``dgl_tpu/data/``; reference
``python/dgl/data/``), with the same modules and public names.

``DGLDataset`` lifecycle (download/process/save/load) mirrors the reference
``data/dgl_dataset.py``. Network downloads are gated; every built-in
dataset supports a deterministic ``synthetic=True`` fallback that
generates a structurally-similar graph with planted class structure — the
JAX package's graph, draw for draw — so examples, tests and ``chip_smoke.py``
run hermetically. Graphs and frames lie on ``device`` (``"cuda"`` unless
the caller asks for the CPU); labels and ids are int64, features float32
and masks bool. Nothing here imports networkx, yaml, pyarrow or ogb at
import time.
"""
from .dgl_dataset import DGLDataset, download, extract_archive, get_download_dir
from .serialize import (
    save_graphs, load_graphs, save_info, load_info,
    StorageMetaData, load_graph_v1, load_graph_v2,
    load_labels, load_labels_v1, load_labels_v2,
    load_tensors, save_tensors, storage_metadata,
)
from .citation import (
    CitationGraphDataset,
    CoraGraphDataset,
    CiteseerGraphDataset,
    PubmedGraphDataset,
)
from .synthetic import (
    synthetic_classification_graph,
    synthetic_hetero_graph,
    SyntheticHeteroDataset,
    SyntheticDataset,
    RedditDataset,
    PPIDataset,
)
from .csv_dataset import CSVDataset
from .adapter import AsNodePredDataset, AsLinkPredDataset, AsGraphPredDataset, from_ogb
from .synthetic import KnowledgeGraphDataset, GraphClassificationDataset, FraudDataset
from .synthetic import (
    CoraFullDataset,
    AmazonCoBuyComputerDataset,
    AmazonCoBuyPhotoDataset,
    CoauthorCSDataset,
    CoauthorPhysicsDataset,
    WikiCSDataset,
    FlickrDataset,
    YelpDataset,
    ActorDataset,
    ChameleonDataset,
    SquirrelDataset,
    CornellDataset,
    TexasDataset,
    WisconsinDataset,
    split_dataset,
)
from .generators import BAShapeDataset, TreeCycleDataset, TreeGridDataset, MiniGCDataset, KarateClubDataset, SBMMixtureDataset

# GIN alias (reference data/gindt.py): synthetic stand-in with planted
# structure; TUDataset is the real-format parser in named_extra
GINDataset = GraphClassificationDataset

from .named_extra import (
    FB15kDataset, FB15k237Dataset, WN18Dataset,
    AIFBDataset, MUTAGDataset, BGSDataset, AMDataset,
    QM7bDataset, QM9Dataset, QM9EdgeDataset, ZINCDataset,
    MNISTSuperPixelDataset, CIFAR10SuperPixelDataset,
    PATTERNDataset, CLUSTERDataset,
    ICEWS18Dataset, GDELTDataset,
    FraudYelpDataset, FraudAmazonDataset,
    BitcoinOTCDataset, SSTDataset, MovieLensDataset,
    FakeNewsDataset, TUDataset, LegacyTUDataset, LegacyPPIDataset,
)
from .named_extra import (
    SuperPixelDataset,
    PeptidesFunctionalDataset, PeptidesStructuralDataset,
    VOCSuperpixelsDataset, COCOSuperpixelsDataset,
    RDFGraphDataset, Entity,
    GNNBenchmarkDataset, AmazonCoBuy, Coauthor, CoraFull,
    GeomGCNDataset, CoraBinary,
)
from .heterophilous import (
    HeterophilousGraphDataset,
    RomanEmpireDataset, AmazonRatingsDataset, MinesweeperDataset,
    TolokersDataset, QuestionsDataset,
)
from .generators import BACommunityDataset, BA2MotifDataset
from .csv_dataset import (
    MetaYaml, MetaNode, MetaEdge, MetaGraph,
    BaseData, NodeData, EdgeData, GraphData, HeteroGraphData,
    DefaultDataParser, DGLGraphConstructor,
)
from .utils import (
    idx2mask, generate_mask_tensor, Subset,
    add_nodepred_split, add_node_property_split,
    eliminate_self_loops, build_knowledge_graph,
    compute_adjacency_matrix_images, compute_edges_list,
    check_sha1, check_local_file_exists, is_local_path, check_pytorch,
    deprecate_function, deprecate_class, deprecate_property,
    load_data, load_cora, load_citeseer, load_pubmed,
    makedirs, loadtxt, sigma, sbm, negative_sample,
    mask_nodes_by_property, tensor_dict_to_ndarray_dict,
    save_heterographs, load_yaml_with_sanity_check,
)
from . import utils
from . import named_extra

# short aliases the reference also exports (``data/__init__.py``)
KarateClub = KarateClubDataset
SBMMixture = SBMMixtureDataset
QM7b = QM7bDataset
QM9 = QM9Dataset
QM9Edge = QM9EdgeDataset
GDELT = GDELTDataset
ICEWS18 = ICEWS18Dataset
SST = SSTDataset
BitcoinOTC = BitcoinOTCDataset
DGLBuiltinDataset = DGLDataset

__all__ = [
    "FB15kDataset",
    "FB15k237Dataset",
    "WN18Dataset",
    "AIFBDataset",
    "MUTAGDataset",
    "BGSDataset",
    "AMDataset",
    "QM7bDataset",
    "QM9Dataset",
    "QM9EdgeDataset",
    "ZINCDataset",
    "MNISTSuperPixelDataset",
    "CIFAR10SuperPixelDataset",
    "PATTERNDataset",
    "CLUSTERDataset",
    "ICEWS18Dataset",
    "GDELTDataset",
    "FraudYelpDataset",
    "FraudAmazonDataset",
    "BitcoinOTCDataset",
    "SSTDataset",
    "MovieLensDataset",
    "FakeNewsDataset",
    "LegacyTUDataset",
    "LegacyPPIDataset",
    "KarateClub",
    "SBMMixture",
    "QM7b",
    "QM9",
    "QM9Edge",
    "GDELT",
    "ICEWS18",
    "SST",
    "BitcoinOTC",
    "DGLBuiltinDataset",

    "DGLDataset",
    "download",
    "extract_archive",
    "save_graphs",
    "load_graphs",
    "save_info",
    "load_info",
    "CitationGraphDataset",
    "CoraGraphDataset",
    "CiteseerGraphDataset",
    "PubmedGraphDataset",
    "synthetic_classification_graph",
    "synthetic_hetero_graph",
    "SyntheticHeteroDataset",
    "SyntheticDataset",
    "RedditDataset",
    "PPIDataset",
    "CSVDataset",
    "AsNodePredDataset",
    "AsLinkPredDataset",
    "AsGraphPredDataset",
    "from_ogb",
    "KnowledgeGraphDataset",
    "GraphClassificationDataset",
    "FraudDataset",
    "CoraFullDataset",
    "AmazonCoBuyComputerDataset",
    "AmazonCoBuyPhotoDataset",
    "CoauthorCSDataset",
    "CoauthorPhysicsDataset",
    "WikiCSDataset",
    "FlickrDataset",
    "YelpDataset",
    "ActorDataset",
    "ChameleonDataset",
    "SquirrelDataset",
    "CornellDataset",
    "TexasDataset",
    "WisconsinDataset",
    "split_dataset",
    "BAShapeDataset",
    "TreeCycleDataset",
    "TreeGridDataset",
    "MiniGCDataset",
    "KarateClubDataset",
    "SBMMixtureDataset",
    "TUDataset",
    "GINDataset",
]
