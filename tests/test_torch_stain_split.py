"""Offline graphs (``SlideDataset.preprocess_all``) against the graphs that
``DGDMPredictor.predict_slide`` builds, in both packages, on the CPU.

The two paths normalize stains at different places: ``preprocess_all``'s
``SlideProcessor`` normalizes the uint8 patches before the featurizer, the
predictor's featurizer runs its own fused Macenko (JAX
``preprocessing/slide_processor.py:301-307`` against
``evaluation/predictor.py``). Their features differ, so some morphological
(cosine) neighbours differ while positions and spatial neighbours are equal.
This holds in the JAX package as in the port: on two small deflate-tiled
TIFF slides (32-px patches, the ``"stats"`` featurizer, 14-d features) each
package's two paths agree on positions, node masks and the 8 spatial slots,
disagree on some morphological slots, and the port's agreement is the JAX
package's within 2 slots in 100 (the 14-d cosines are f64 in the port and f32
in JAX, so near-ties may fall the other way), its feature gap between the
paths within 1e-4 of JAX's.
"""

import os

import numpy as np
import pytest

from dgdm_histopath_tpu.data import dataset as jds
from dgdm_histopath_tpu.evaluation import DGDMPredictor as JaxPredictor
from dgdm_histopath_tpu.preprocessing.slide_processor import SlideProcessor as JaxProcessor
from dgdm_histopath_tpu.preprocessing.tissue_graph_builder import (
    TissueGraphBuilder as JaxBuilder,
)
from dgdm_histopath_torch.data import SlideDataset
from dgdm_histopath_torch.evaluation.predictor import DGDMPredictor
from dgdm_histopath_torch.preprocessing import SlideProcessor, TissueGraphBuilder
from test_torch_slide import _models, _write_slides

SLIDE_KW = dict(patch_size=32, max_patches=30, tissue_threshold=0.3)
BUCKETS = [32, 64]
K_SPATIAL = 8


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _two_paths(dataset, predictor, paths, out_dir):
    """[(preprocess_all's graph, predict_slide's graph)] as numpy dicts."""
    written = dataset.preprocess_all(out_dir)
    built = []
    build = predictor.graph_builder.build_graph

    def capture(*a, **k):
        built.append(build(*a, **k))
        return built[-1]
    predictor.graph_builder.build_graph = capture
    for p in paths:
        predictor.predict_slide(p)
    fields = ("x", "pos", "nbr_idx", "nbr_mask", "node_mask")
    return [(_npz(w), {f: np.asarray(getattr(g, f)) for f in fields})
            for w, g in zip(written, built)]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    d = tmp_path_factory.mktemp("split")
    paths = _write_slides(d, (31, 32))
    jm, params, tm = _models(14)
    pred_kw = dict(SLIDE_KW, feature_extractor="stats", stain_normalize=True,
                   node_buckets=BUCKETS, decode_workers=1)
    port = _two_paths(
        SlideDataset(paths, SlideProcessor(stain_normalize=True, device="cpu", **SLIDE_KW),
                     TissueGraphBuilder("stats", node_buckets=BUCKETS, device="cpu")),
        DGDMPredictor(model=tm, device="cpu", **pred_kw), paths, d / "port")
    old = os.environ.get("DGDM_NATIVE_IO")
    os.environ["DGDM_NATIVE_IO"] = "0"
    try:
        ref = _two_paths(
            jds.SlideDataset(paths, JaxProcessor(stain_normalize=True, **SLIDE_KW),
                             JaxBuilder("stats", node_buckets=BUCKETS)),
            JaxPredictor(model=jm, params=params, **pred_kw), paths, d / "jax")
    finally:
        if old is None:
            del os.environ["DGDM_NATIVE_IO"]
        else:
            os.environ["DGDM_NATIVE_IO"] = old
    return port, ref


def _morph_agreement(a, b) -> float:
    return float((a["nbr_idx"][:, K_SPATIAL:] == b["nbr_idx"][:, K_SPATIAL:]).mean())


@pytest.mark.parametrize("slide", [0, 1])
def test_offline_and_predict_slide_graphs_split_as_in_jax(split, slide):
    port, ref = split
    for offline, online in (port[slide], ref[slide]):
        for f in ("pos", "node_mask"):
            np.testing.assert_array_equal(offline[f], online[f], err_msg=f)
        np.testing.assert_array_equal(offline["nbr_idx"][:, :K_SPATIAL],
                                      online["nbr_idx"][:, :K_SPATIAL])
    ours, theirs = _morph_agreement(*port[slide]), _morph_agreement(*ref[slide])
    assert theirs < 1.0 and ours < 1.0          # the reference splits too
    assert abs(ours - theirs) <= 0.02
    gap_ours = np.abs(port[slide][0]["x"] - port[slide][1]["x"]).max()
    gap_theirs = np.abs(ref[slide][0]["x"] - ref[slide][1]["x"]).max()
    assert gap_theirs > 1e-3 and abs(gap_ours - gap_theirs) <= 1e-4
