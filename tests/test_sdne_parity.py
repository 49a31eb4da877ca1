"""SDNE activation parity (BASELINE quality target).

A pure-numpy re-execution of the reference TF graph formulas
(``SDNE/SDNE.py:66-122``): per-layer activations, the embedding tensor
(``answer``), and every loss term must match our JAX implementation at
the same weights — checked on real data (scikit-learn digits; the
reference's mnist.pkl.gz needs a network download) after a short
fixed-seed training run, and on the exact [784,400,100,300,784] net
shape with a synthetic batch.
"""

import dataclasses

import jax
import numpy as np
import pytest

from graphtpu.core.config import SDNEConfig
from graphtpu.models.sdne import forward, init_params, loss_fn, train_sdne


def _np_l2(x):
    return np.sum(np.square(x)) / 2.0  # tf.nn.l2_loss


def _np_reference_graph(params, x, minibatch, p1=0.005):
    """Literal numpy transcription of SDNE.py:88-122 (TF graph formulas)."""
    (w1, b1), (w2, b2), (w3, b3), (w4, b4) = [
        (np.asarray(w, np.float64), np.asarray(b, np.float64))
        for (w, b) in params
    ]
    x = np.asarray(x, np.float64)
    hidden1 = np.maximum(x @ w1 + b1, 0.0)            # SDNE.py:88
    answer = hidden1 @ w2 + b2                        # SDNE.py:95
    hidden2 = np.maximum(answer, 0.0)                 # SDNE.py:89
    hidden3 = np.maximum(hidden2 @ w3 + b3, 0.0)      # SDNE.py:90
    y = hidden3 @ w4 + b4                             # SDNE.py:94
    y_ = x                                            # autoencoder target
    regularizer = np.mean(_np_l2(y - y_) / (1.0 * minibatch))   # :104
    reg1 = sum(
        _np_l2(a) for pair in [(w1, b1), (w2, b2), (w3, b3), (w4, b4)]
        for a in pair
    )                                                  # :106
    sumq = np.mean(hidden2)                            # :115
    reg2 = p1 * np.log(p1 / (sumq + 1e-8)) + (1.0 - p1) * np.log(
        (1.0 - p1) / (1.0 - sumq + 1e-8)
    )                                                  # :116
    total = regularizer + 1e-1 * reg1 + 1e-1 * reg2    # :105,109,121
    return {
        "hidden1": hidden1, "answer": answer, "hidden2": hidden2,
        "hidden3": hidden3, "y": y, "recon": regularizer,
        "reg1": reg1, "reg2": reg2, "total": total,
    }


def _assert_parity(params, x, cfg):
    acts = {k: np.asarray(v) for k, v in forward(params, x).items()}
    total, terms = loss_fn(params, x, cfg)
    ref = _np_reference_graph(params, np.asarray(x), cfg.minibatch,
                              cfg.sparsity_p)
    for name in ["hidden1", "answer", "hidden2", "hidden3", "y"]:
        scale = max(1.0, np.abs(ref[name]).max())
        np.testing.assert_allclose(
            acts[name], ref[name], atol=2e-4 * scale,
            err_msg=f"activation {name}",
        )
    np.testing.assert_allclose(float(terms["recon"]), ref["recon"], rtol=1e-4)
    np.testing.assert_allclose(float(terms["reg1"]), ref["reg1"], rtol=1e-4)
    np.testing.assert_allclose(float(terms["reg2"]), ref["reg2"], rtol=1e-3)
    np.testing.assert_allclose(float(total), ref["total"], rtol=1e-4)


def test_sdne_activation_parity_digits_trained():
    """Real data (sklearn digits), short fixed-seed training, then full
    per-layer parity of the trained net against the TF-formula oracle."""
    from sklearn.datasets import load_digits

    x = (load_digits().data / 16.0).astype(np.float32)[:500]
    cfg = SDNEConfig(units=(64, 40, 16, 30, 64), minibatch=100, seed=3)
    params, embed = train_sdne(x, cfg, steps=60)
    _assert_parity(params, jax.numpy.asarray(x[:100]), cfg)
    # the embedding tensor is the layer-2 PRE-activation (SDNE.py:95,170)
    emb = np.asarray(embed(jax.numpy.asarray(x[:10])))
    ref = _np_reference_graph(params, x[:10], cfg.minibatch)
    np.testing.assert_allclose(emb, ref["answer"], atol=1e-4)


def test_sdne_activation_parity_reference_shape():
    """The exact reference net [784,400,100,300,784] at init weights."""
    cfg = SDNEConfig()  # reference defaults
    assert tuple(cfg.units) == (784, 400, 100, 300, 784)
    params = init_params(cfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    x = jax.numpy.asarray(rng.random((100, 784), dtype=np.float32))
    _assert_parity(params, x, cfg)
