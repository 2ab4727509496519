# ported from vidsum_tpu/data/paths.py
"""Dataset-name -> HDF5-filename maps.

The reference carries two divergent copies: the data layer's map points
summe/tvsum at the ``summarizer_dataset_*`` files, which carry the
``user_scores`` key needed for tau/rho (``src/data/path.py:1-6``), while the
eval and export modules use the ``eccv16_dataset_*`` names
(``src/evaluation/compute_metrics.py:11-16``). Both are kept, explicitly
named; the data layer defaults to the summarizer scheme like the reference.
"""

PATH = {
    "ovp": "eccv16_dataset_ovp_google_pool5.h5",
    "summe": "summarizer_dataset_summe_google_pool5.h5",
    "tvsum": "summarizer_dataset_tvsum_google_pool5.h5",
    "youtube": "eccv16_dataset_youtube_google_pool5.h5",
}

ECCV16_PATH = {
    "ovp": "eccv16_dataset_ovp_google_pool5.h5",
    "summe": "eccv16_dataset_summe_google_pool5.h5",
    "tvsum": "eccv16_dataset_tvsum_google_pool5.h5",
    "youtube": "eccv16_dataset_youtube_google_pool5.h5",
}


def h5_name(dataset: str, scheme: str = "summarizer") -> str:
    table = PATH if scheme == "summarizer" else ECCV16_PATH
    return table[dataset]
