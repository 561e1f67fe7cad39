"""Carry models built by the JAX package across: a KNN index and
classifier, a Naive Bayes model, a free-text Naive Bayes model, a Markov
transition model, a hidden Markov model, an SVM, a bagged SVM and a
basic neural net. (A
tree travels as its DecisionPathList JSON, which `tree.DecisionPathList.load`
reads as the JAX package wrote it.)

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
where it was loaded from a model file) with its class values and bins;
a JAX `TextNaiveBayes` as its `log_prob`, `log_prior` and class-count
arrays with its vocabulary (in code order), class values, `laplace` and
`drop_stop`. A JAX `MarkovStateTransitionModel` travels as its states,
scale, class labels and float64 `counts` [C, S, S]; a JAX
`HiddenMarkovModel` as its states, observations and its initial,
transition and emission arrays. A JAX `SVMClassifier` or `BaggedSVM`
travels as its hyperparameters with `x_train`, `dual_coef(s)` and
`intercept(s)` (read off the object, `svm_from_jax`,
`bagged_svm_from_jax`); a JAX `BasicNeuralNetwork`'s params dict (`w1`,
`b1`, `w2`, `b2`) as numpy arrays, into the port's module
(`neural_params_from_jax`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.models.knn import NearestNeighborClassifier, NeighborIndex
from avenir_tpu_torch.models.markov import (HiddenMarkovModel,
                                            MarkovStateTransitionModel)
from avenir_tpu_torch.models.naive_bayes import NaiveBayesModel
from avenir_tpu_torch.models.neural import TwoLayerNet
from avenir_tpu_torch.models.svm import BaggedSVM, SVMClassifier
from avenir_tpu_torch.models.text import TextNaiveBayes
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


def text_nb_from_jax_arrays(arrays: Dict[str, Optional[np.ndarray]],
                            meta: Dict[str, object],
                            device: DeviceLike = None) -> TextNaiveBayes:
    """The port's TextNaiveBayes over a JAX text model's arrays
    (`log_prob` [V, K], `log_prior` [K], and `class_counts` [K], empty
    for a model loaded from its file) and its `meta` (`vocab`, the tokens
    in code order; `class_values`; `laplace`; `drop_stop`). It scores,
    predicts and saves as the JAX model does. The class counts, where
    there are any, must give the prior."""
    vocab = list(meta["vocab"])
    classes = list(meta["class_values"])
    log_prob = np.asarray(arrays["log_prob"], np.float64)
    log_prior = np.asarray(arrays["log_prior"], np.float64)
    if log_prob.shape != (len(vocab), len(classes)) \
            or log_prior.shape != (len(classes),):
        raise ValueError(
            f"log_prob {log_prob.shape} and log_prior {log_prior.shape} do "
            f"not match {len(vocab)} tokens and {len(classes)} classes")
    counts = np.asarray(arrays.get("class_counts", ()), np.float64)
    if counts.size and not np.allclose(
            np.log(np.maximum(counts / max(counts.sum(), 1.0), 1e-30)),
            log_prior):
        raise ValueError("class_counts do not give log_prior")
    model = TextNaiveBayes(laplace=float(meta["laplace"]),
                           drop_stop_words=bool(meta["drop_stop"]),
                           device=device)
    model.vocab = {tok: i for i, tok in enumerate(vocab)}
    model.class_values = classes
    model.log_prob = log_prob.copy()
    model.log_prior = log_prior.copy()
    return model


def markov_model_from_jax_arrays(states: Sequence[str], scale: int,
                                 class_labels: Optional[Sequence[str]],
                                 counts: np.ndarray,
                                 device: DeviceLike = None
                                 ) -> MarkovStateTransitionModel:
    """The port's MarkovStateTransitionModel over a JAX model's states,
    scale, class labels (None for one unlabelled matrix) and counts
    [C, S, S]: it saves, merges, keeps counting and classifies as the JAX
    model does."""
    model = MarkovStateTransitionModel(states, scale=int(scale),
                                       class_labels=class_labels,
                                       device=device)
    counts = np.asarray(counts, np.float64)
    if counts.shape != model.counts.shape:
        raise ValueError(
            f"counts have shape {counts.shape}; {len(model.states)} states "
            f"and {model.counts.shape[0]} class matrices give "
            f"{model.counts.shape}")
    model.counts = counts.copy()
    return model


def hmm_from_jax_arrays(states: Sequence[str], observations: Sequence[str],
                        initial: np.ndarray, transition: np.ndarray,
                        emission: np.ndarray) -> HiddenMarkovModel:
    """The port's HiddenMarkovModel over a JAX HMM's states, observations
    and float64 initial [S], transition [S, S] and emission [S, O]."""
    s, o = len(states), len(observations)
    arrays = {name: np.asarray(a, np.float64).copy() for name, a in
              (("initial", initial), ("transition", transition),
               ("emission", emission))}
    want = {"initial": (s,), "transition": (s, s), "emission": (s, o)}
    for name, shape in want.items():
        if arrays[name].shape != shape:
            raise ValueError(f"{name} has shape {arrays[name].shape}; "
                             f"{s} states and {o} observations give {shape}")
    return HiddenMarkovModel(list(states), list(observations),
                             arrays["initial"], arrays["transition"],
                             arrays["emission"])


_SVM_KEYS = ("kernel", "c", "gamma", "degree", "coef0", "learning_rate",
             "epochs")


def svm_from_jax(model, device: DeviceLike = None) -> SVMClassifier:
    """The port's SVMClassifier with a JAX SVMClassifier's hyperparameters
    and fitted state (`x_train`, `dual_coef`, `intercept`), on `device`."""
    m = SVMClassifier(**{k: getattr(model, k) for k in _SVM_KEYS},
                      device=device)
    if model.dual_coef is not None:
        m.x_train = np.asarray(model.x_train, np.float32)
        m.dual_coef = np.asarray(model.dual_coef, np.float32)
    m.intercept = float(model.intercept)
    return m


def bagged_svm_from_jax(model, device: DeviceLike = None) -> BaggedSVM:
    """The port's BaggedSVM with a JAX BaggedSVM's base hyperparameters,
    ensemble settings and fitted state (`x_train`, `dual_coefs` [E, n],
    `intercepts` [E], `oob_score_`), on `device`."""
    m = BaggedSVM(svm_from_jax(model.base, device), model.num_estimators,
                  model.sample_fraction, model.use_oob)
    if model.dual_coefs is not None:
        m.x_train = np.asarray(model.x_train)
        m.dual_coefs = np.asarray(model.dual_coefs, np.float32)
        m.intercepts = np.asarray(model.intercepts, np.float32)
    m.oob_score_ = model.oob_score_
    return m


def neural_params_from_jax(params: Dict[str, np.ndarray],
                           device: DeviceLike = None) -> TwoLayerNet:
    """The port's net from a JAX BasicNeuralNetwork's params dict (`w1`
    [n_in, n_hidden], `b1`, `w2` [n_hidden, n_out], `b2`) as numpy."""
    dev = resolve_device(device)
    return TwoLayerNet(*(torch.from_numpy(np.array(params[k], np.float32))
                         .to(dev) for k in ("w1", "b1", "w2", "b2")))
