"""The port's data layer (``data/dataset.py``, ``data/datamodule.py``)
against the JAX package's, on the CPU.

Augmentations and node subsampling draw from one numpy ``RandomState`` in
both packages: bit-equal. Discovery order, labels, loaded graphs, the
loader's batches (shuffle, ``drop_last``, fillers) over two epochs, and the
data module's splits and shards: equal. Graphs built from slides with the
``"stats"`` featurizer and no stain normalization: neighbour lists equal,
features and edge features within 1e-5 (with the strong augmentation, each
node's neighbour set equal).
"""

import threading

import numpy as np
import pytest
import torch

from conftest import make_synthetic_graph
from dgdm_histopath_tpu.data import dataset as jds
from dgdm_histopath_tpu.data.datamodule import BucketedLoader as JaxLoader
from dgdm_histopath_tpu.data.datamodule import HistopathDataModule as JaxDataModule
from dgdm_histopath_tpu.preprocessing.slide_processor import SlideProcessor as JaxProcessor
from dgdm_histopath_tpu.preprocessing.tissue_graph_builder import (
    TissueGraphBuilder as JaxBuilder,
)
from dgdm_histopath_torch.data import (
    BucketedLoader,
    GraphDataset,
    HistopathDataModule,
    HistopathDataset,
    SlideDataset,
    augment_patches,
    empty_graph,
    load_labels,
    save_graph,
)
from dgdm_histopath_torch.preprocessing import synthetic
from dgdm_histopath_torch.preprocessing.slide_processor import SlideProcessor
from dgdm_histopath_torch.preprocessing.tiff import write_tiled_tiff
from dgdm_histopath_torch.preprocessing.tissue_graph_builder import TissueGraphBuilder
from dgdm_histopath_torch.utils.exceptions import DataError
from test_torch_training import to_torch_graph

FIELDS = ("x", "pos", "nbr_idx", "nbr_mask", "edge_attr", "node_mask", "y")
SLIDE_KW = dict(patch_size=32, max_patches=30, tissue_threshold=0.3)
BUCKETS = [32, 64]


def arrays(g):
    return {f: None if getattr(g, f) is None else np.asarray(getattr(g, f)) for f in FIELDS}


def assert_same_graph(port, ref, tol=0.0):
    a, b = arrays(port), arrays(ref)
    for f in FIELDS:
        if a[f] is None or b[f] is None:
            assert a[f] is None and b[f] is None, f
        elif tol and a[f].dtype.kind == "f":
            np.testing.assert_allclose(a[f], b[f], atol=tol, rtol=tol, err_msg=f)
        else:
            assert a[f].shape == b[f].shape and np.array_equal(a[f], b[f]), f


def mixed_graphs(n=11):
    """JAX graphs of two buckets (32 and 64 nodes), labelled."""
    return [make_synthetic_graph(n_nodes=32 if i % 3 else 64, n_real=20 if i % 3 else 40,
                                 feat_dim=8, seed=i, num_classes=2) for i in range(n)]


@pytest.fixture(scope="module")
def graph_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    graphs = mixed_graphs(9)
    for i, g in enumerate(graphs):
        # labels come from the metadata file: the stored y is left out
        save_graph(to_torch_graph(g.replace(y=None)), d / "data" / f"case{i}_graph.npz")
    (d / "labels.csv").write_text("slide_id,label\n" + "\n".join(
        f"case{i},{i % 2}" for i in range(9)))
    (d / "labels.json").write_text("{" + ", ".join(f'"case{i}": {i % 3}' for i in range(9)) + "}")
    return d


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("level", ["none", "light", "strong"])
def test_augment_patches_bit_equal(level, seed):
    patches = np.random.RandomState(9).randint(0, 256, (5, 16, 12, 3)).astype(np.uint8)
    ours = augment_patches(patches, level, np.random.RandomState(seed))
    theirs = jds.augment_patches(patches, level, np.random.RandomState(seed))
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


@pytest.mark.parametrize("metadata", ["labels.csv", "labels.json"])
def test_histopath_dataset_order_labels_and_graphs_match_jax(graph_dir, metadata):
    ours = HistopathDataset(graph_dir / "data", metadata_path=graph_dir / metadata)
    theirs = jds.HistopathDataset(graph_dir / "data", metadata_path=graph_dir / metadata)
    assert [p.name for p in ours.files] == [p.name for p in theirs.files]
    assert ours.labels == theirs.labels == load_labels(graph_dir / metadata)
    for i in range(len(ours)):
        assert_same_graph(ours[i], theirs[i])
        assert ours[i] is ours[i]                         # the cache
    with pytest.raises(DataError):
        HistopathDataset(graph_dir / "missing")


def test_graph_dataset_subsample_bit_equal(graph_dir):
    paths = sorted((graph_dir / "data").glob("*.npz"))
    labels = load_labels(graph_dir / "labels.csv")
    ours = GraphDataset(paths, labels=labels, max_nodes=15, seed=4)
    theirs = jds.GraphDataset(paths, labels=labels, max_nodes=15, seed=4)
    for i in range(len(paths)):
        a, b = ours[i], theirs[i]
        assert_same_graph(a, b)
        assert int(a.node_mask.sum()) == 15


def test_empty_graph_matches_jax():
    assert_same_graph(empty_graph(7, 32, max_neighbors=5, y=1),
                      jds.empty_graph(7, 32, max_neighbors=5, y=1))


@pytest.fixture(scope="module")
def slide_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("slides")
    for s in (21, 22, 23):
        img, _ = synthetic.generate_tissue_image(512, 512, seed=s)
        write_tiled_tiff(d / f"slide{s}.tif", synthetic.build_pyramid(img, 3), tile=128,
                         compression="deflate", description="Aperio S|AppMag = 20")
    (d / "broken.tif").write_bytes(b"not a tiff at all")
    return d


def _slide_datasets(slide_dir, **kw):
    paths = sorted(slide_dir.glob("*.tif"))
    labels = {p.stem: i % 2 for i, p in enumerate(paths)}
    ours = SlideDataset(paths, SlideProcessor(stain_normalize=False, device="cpu", **SLIDE_KW),
                        TissueGraphBuilder("stats", node_buckets=BUCKETS, device="cpu"),
                        labels=labels, **kw)
    theirs = jds.SlideDataset(paths, JaxProcessor(stain_normalize=False, **SLIDE_KW),
                              JaxBuilder("stats", node_buckets=BUCKETS), labels=labels, **kw)
    return paths, ours, theirs


def test_slide_dataset_graphs_and_empty_fallback_match_jax(slide_dir):
    paths, ours, theirs = _slide_datasets(slide_dir)
    for i, p in enumerate(paths):
        a, b = ours[i], theirs[i]
        assert_same_graph(a, b, tol=1e-5)
        if p.stem == "broken":                           # the empty-graph fallback
            assert a.num_nodes == BUCKETS[0] and a.max_neighbors == 24
            assert not a.node_mask.any() and int(a.y) == int(b.y)
        else:
            assert a.node_mask.any()


def test_slide_dataset_augments_as_jax(slide_dir):
    """The strong augmentation's draws are the reference's: features within
    1e-5 and each node's neighbour set equal (the noise leaves near-ties in
    the cosine keys, which may swap two slots of a row)."""
    paths, ours, theirs = _slide_datasets(slide_dir, augmentations="strong", seed=3)
    for i in range(len(paths)):
        a, b = arrays(ours[i]), arrays(theirs[i])
        np.testing.assert_allclose(a["x"], b["x"], atol=1e-5, rtol=1e-5)
        assert np.array_equal(a["node_mask"], b["node_mask"])
        assert np.array_equal(np.sort(a["nbr_idx"], -1), np.sort(b["nbr_idx"], -1))
        assert (a["nbr_idx"] != b["nbr_idx"]).mean() < 0.01


def test_preprocess_all_writes_graphs_that_load_back(slide_dir, tmp_path):
    paths, ours, _ = _slide_datasets(slide_dir, cache_graphs=False)
    built = [ours[i] for i in range(len(paths))]
    written = ours.preprocess_all(tmp_path / "pre")
    assert len(written) == len(paths) - 1                # the broken slide is left out
    again = SlideDataset(paths, ours.processor, ours.graph_builder, labels=ours.labels,
                         preprocessed_dir=tmp_path / "pre")
    for i, p in enumerate(paths):
        if p.stem != "broken":
            assert_same_graph(again[i], built[i])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 14"):
        ours.preprocess_all(tmp_path / "pre2", num_workers=2)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True),
                                               (False, True)])
def test_bucketed_loader_batches_match_jax_over_two_epochs(shuffle, drop_last):
    jgraphs = mixed_graphs()
    tgraphs = [to_torch_graph(g) for g in jgraphs]
    ours = BucketedLoader(tgraphs, 3, shuffle=shuffle, seed=5, drop_last=drop_last)
    theirs = JaxLoader(jgraphs, 3, shuffle=shuffle, seed=5, drop_last=drop_last)
    assert len(ours) == len(theirs)
    for _ in range(2):
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert_same_graph(x, y)
    fillers = [int((~x.node_mask.any(-1)).sum()) for x in BucketedLoader(tgraphs, 3)]
    assert sum(fillers) > 0                              # incomplete groups were filled


def test_bucketed_loader_hands_on_producer_errors_and_stops_early():
    class Failing:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise DataError("bad item")
            return to_torch_graph(make_synthetic_graph(n_nodes=32, n_real=20, feat_dim=8))

    with pytest.raises(DataError, match="bad item"):
        list(BucketedLoader(Failing(), 2))
    loader = BucketedLoader([to_torch_graph(g) for g in mixed_graphs()], 1, prefetch=1)
    before = threading.active_count()
    it = iter(loader)
    next(it)
    assert threading.active_count() == before + 1
    it.close()                                           # the producer thread ends
    assert threading.active_count() == before
    assert sum(1 for _ in loader) == len(loader)


@pytest.mark.parametrize("shards,index", [(1, 0), (2, 1), (3, 2)])
def test_datamodule_splits_and_shards_match_jax(graph_dir, shards, index):
    kw = dict(batch_size=2, train_split=0.6, val_split=0.2, test_split=0.2, seed=7,
              num_shards=shards, shard_index=index)
    ours = HistopathDataModule(HistopathDataset(graph_dir / "data"), **kw)
    theirs = JaxDataModule(jds.HistopathDataset(graph_dir / "data"), **kw)
    assert ours.get_dataset_info() == theirs.get_dataset_info()
    for split in ("train", "val", "test"):
        assert np.array_equal(ours._subset(split).indices, theirs._subset(split).indices)
    for a, b in zip(ours.train_dataloader(), theirs.train_dataloader()):
        assert_same_graph(a, b)
    with pytest.raises(DataError, match="splits must sum"):
        HistopathDataModule([], train_split=0.5, val_split=0.1, test_split=0.1)


def test_datamodule_shards_follow_torch_distributed(monkeypatch, graph_dir):
    """Shards follow the nodes of the process group: three nodes of one rank
    each shard as three JAX processes do; one node of three ranks loads one
    shard (its ranks split each batch)."""
    assert HistopathDataModule([]).num_shards == 1
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 3)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    dm = HistopathDataModule(HistopathDataset(graph_dir / "data"), seed=7)
    assert (dm.num_shards, dm.shard_index) == (1, 0)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    dm = HistopathDataModule(HistopathDataset(graph_dir / "data"), seed=7)
    assert (dm.num_shards, dm.shard_index) == (3, 2)
    ref = JaxDataModule(jds.HistopathDataset(graph_dir / "data"), seed=7, num_shards=3,
                        shard_index=2)
    assert np.array_equal(dm._subset("train").indices, ref._subset("train").indices)
