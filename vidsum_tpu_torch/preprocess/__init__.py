# ported from vidsum_tpu/preprocess/__init__.py
"""The offline preprocess stage: frame decoding at a reduced rate, the
GoogLeNet / R3D-18 backbones, feature extraction and the DSNet-schema
dataset builder.

The JAX package's names map to the port's: ``googlenet_apply`` /
``init_googlenet`` / ``googlenet_from_torch_state`` / ``fold_googlenet``
are :class:`GoogLeNet` (seeded init, ``load_torch_state``, ``fold``) and
:func:`googlenet_params_from_jax`; the R3D-18 ones :class:`R3D18` and
:func:`r3d18_params_from_jax`. ``reduce_fps`` here is the *module* (its
function is ``reduce_fps.reduce_fps``): the JAX package re-exports the
function under the module's name, which hides the module that the
pipeline looks ``iter_reduced_frames`` up in.
"""

from vidsum_tpu_torch.preprocess import reduce_fps
from vidsum_tpu_torch.preprocess.extract import (
    FeatureExtractor, get_google_net_features, get_video_feature,
    load_backbone,
)
from vidsum_tpu_torch.preprocess.googlenet import (
    GoogLeNet, googlenet_params_from_jax,
)
from vidsum_tpu_torch.preprocess.r3d import R3D18, r3d18_params_from_jax
from vidsum_tpu_torch.preprocess.transforms import (
    device_normalize, imagenet_normalize, resize_shorter_side,
    video_normalize,
)

__all__ = [
    "GoogLeNet", "googlenet_params_from_jax", "R3D18",
    "r3d18_params_from_jax", "imagenet_normalize", "video_normalize",
    "resize_shorter_side", "device_normalize", "reduce_fps",
    "get_google_net_features", "get_video_feature", "FeatureExtractor",
    "load_backbone",
]
