"""Carry models built by the JAX package across: a KNN index and
classifier, and a Naive Bayes model.

The JAX `NeighborIndex` and `NearestNeighborClassifier` hold their train
state as arrays; saved as numpy (`t_num`, `t_cat`, `ranges`,
`train_labels`, `train_post`) with their attributes (`k`, `metric`,
`block`, `n_valid`, `n_attrs`, `cat_bins`, `use_pallas`, `packed`), they
rebuild here as the port's objects, which find the same neighbours.

Two layouts arrive:
- the jnp route (what JAX builds off a TPU): raw numeric rows, categorical
  codes and the schema ranges, padded to `block` rows;
- the kernel route (`use_pallas`): rows already normalized, one-hot
  expanded and padded (JAX knn.py:176-188).
Both become a kernel-route index here where the kernels apply.

A JAX `NaiveBayesModel` travels as its count arrays (`post_counts`,
`cont_moments`, `class_counts`, and `cont_params` / `cont_prior_params`
where it was loaded from a model file) with its class values and bins.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.models.knn import NearestNeighborClassifier, NeighborIndex
from avenir_tpu_torch.models.naive_bayes import NaiveBayesModel
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device


def index_from_jax_arrays(arrays: Dict[str, Optional[np.ndarray]],
                          meta: Dict[str, object],
                          device: DeviceLike = None) -> NeighborIndex:
    """The port's NeighborIndex over a JAX index's arrays and attributes."""
    n_valid = int(meta["n_valid"])
    bins = tuple(meta["cat_bins"]) if meta.get("cat_bins") else None
    ranges = arrays.get("ranges")
    ranges = (np.zeros((0,), np.float32) if ranges is None
              else np.asarray(ranges, np.float32))
    t_num = np.asarray(arrays["t_num"], np.float32)[:n_valid]
    k, metric = int(meta["k"]), str(meta["metric"])
    if meta["use_pallas"]:
        return NeighborIndex.from_expanded(
            t_num, int(meta["n_attrs"]), ranges, bins, k, metric,
            bool(meta["packed"]), device)
    t_cat = arrays.get("t_cat")
    x_cat = None if t_cat is None else np.asarray(t_cat, np.int32)[:n_valid]
    index = NeighborIndex.__new__(NeighborIndex)
    index._setup(t_num, ranges, x_cat, bins, n_valid, k, metric,
                 int(meta["block"]), bool(meta["packed"]),
                 resolve_device(device))
    return index


def classifier_from_jax_arrays(arrays: Dict[str, Optional[np.ndarray]],
                               meta: Dict[str, object],
                               class_values: Sequence[str],
                               device: DeviceLike = None,
                               **params) -> NearestNeighborClassifier:
    """The port's classifier over a JAX classifier's index arrays plus its
    `train_labels` and `train_post`; `params` are the classifier's own
    (kernel_function, kernel_param, decision_threshold, fused, ...)."""
    index = index_from_jax_arrays(arrays, meta, device)
    return NearestNeighborClassifier.from_index(
        index, np.asarray(arrays["train_labels"]), class_values,
        train_post=arrays.get("train_post"), **params)


def nb_model_from_jax_arrays(arrays: Dict[str, Optional[np.ndarray]],
                             schema: FeatureSchema,
                             class_values: Sequence[str],
                             bins: Sequence[int],
                             device: DeviceLike = None) -> NaiveBayesModel:
    """The port's NaiveBayesModel over a JAX model's arrays. `schema` is
    the port's copy of the model's schema; its class values and bins must
    be the JAX model's, or the count cells would mean other states."""
    model = NaiveBayesModel.empty(schema, device)
    if model.class_values != list(class_values) or model.bins != list(bins):
        raise ValueError(
            f"schema gives classes {model.class_values} and bins "
            f"{model.bins}; the model has {list(class_values)} and "
            f"{list(bins)}")
    for name in ("post_counts", "cont_moments", "class_counts"):
        value = np.asarray(arrays[name], np.float64)
        if value.shape != getattr(model, name).shape:
            raise ValueError(f"{name} has shape {value.shape}, the schema "
                             f"gives {getattr(model, name).shape}")
        setattr(model, name, value.copy())
    for name in ("cont_params", "cont_prior_params"):
        if arrays.get(name) is not None:
            setattr(model, name, np.asarray(arrays[name], np.float64).copy())
    return model
