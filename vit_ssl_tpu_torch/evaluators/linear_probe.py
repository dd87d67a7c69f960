"""Linear probe (after ``vit_ssl_tpu/evaluators/linear_probe.py``), two
backends under the JAX package's names:

- ``"sklearn"`` (the default): what ``sklearn.linear_model.
  LogisticRegression(max_iter=1000, solver="lbfgs")`` fits, without
  sklearn. The multinomial softmax loss over the classes present in the
  train labels, L2 at C = 1 on the weights (not the intercept), in
  sklearn's scaling (mean loss + ‖W‖² / (2·C·n)), minimised in float64 by
  ``scipy.optimize.minimize(method="L-BFGS-B", jac=True)`` with sklearn's
  options (``maxiter`` 1000, ``gtol`` 1e-4, ``maxls`` 50, ``ftol``
  64·eps) from zeros, the parameters laid out as sklearn ravels them
  (each feature's classes contiguous, the intercepts last). The loss and
  its gradient are computed in torch on the evaluation's device; the
  iterations and the final projected-gradient norm are logged.
- ``"optax"``: the JAX package's on-device probe in torch: standardised
  features, zero init, Adam at lr 1e-2 for 500 full-batch steps on the
  mean cross-entropy + 1e-4·‖w‖².
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..device import resolve_device

logger = logging.getLogger(__name__)


def run_linear_evaluation(train_features, train_labels, val_features, val_labels,
                          backend: str = "sklearn", device=None):
    device = resolve_device(device)
    if backend == "sklearn":
        preds, _ = lbfgs_probe(train_features, train_labels, val_features, device)
        accuracy = float((preds == np.asarray(val_labels)).mean())
    else:
        preds, accuracy = _optax_probe(train_features, train_labels, val_features,
                                       val_labels, device=device)
    logger.info("Top-1 Linear Probing Accuracy: %.2f%%", accuracy * 100)
    return {"method": "linear", "accuracy": accuracy, "predictions": preds}


def lbfgs_probe(train_features, train_labels, val_features, device):
    """sklearn's lbfgs logistic regression: (val predictions, the
    ``scipy.optimize.OptimizeResult``)."""
    from scipy import optimize

    y_host = np.asarray(train_labels)
    classes, y_idx = np.unique(y_host, return_inverse=True)
    x = torch.as_tensor(np.asarray(train_features, np.float64)).to(device)
    y = torch.as_tensor(y_idx.astype(np.int64)).to(device)
    n, f = x.shape
    k = len(classes)
    l2 = 1.0 / n  # 1 / (C · n) at C = 1
    onehot = torch.nn.functional.one_hot(y, k).double()

    def loss_gradient(w_flat):
        # (f + 1, k): row j holds feature j's classes, the last row the
        # intercepts (sklearn's order="F" ravel of its (k, f + 1) coef)
        w = torch.as_tensor(w_flat.reshape(f + 1, k)).to(device)
        weights, intercept = w[:f], w[f]
        raw = x @ weights + intercept
        lse = torch.logsumexp(raw, dim=1)
        loss = (lse - raw.gather(1, y[:, None])[:, 0]).sum() / n
        loss = loss + 0.5 * l2 * (weights * weights).sum()
        pointwise = (torch.exp(raw - lse[:, None]) - onehot) / n
        grad = torch.cat([x.T @ pointwise + l2 * weights, pointwise.sum(0, keepdim=True)])
        return float(loss), grad.cpu().numpy().ravel()

    result = optimize.minimize(
        loss_gradient, np.zeros((f + 1) * k), method="L-BFGS-B", jac=True,
        options={"maxiter": 1000, "maxls": 50, "gtol": 1e-4,
                 "ftol": 64 * np.finfo(float).eps})
    logger.info("Linear probe (L-BFGS-B): %d iterations, projected gradient %.3g, %s",
                result.nit, float(np.max(np.abs(result.jac))), result.message)
    w = torch.as_tensor(result.x.reshape(f + 1, k)).to(device)
    xv = torch.as_tensor(np.asarray(val_features, np.float64)).to(device)
    scores = xv @ w[:f] + w[f]
    return classes[torch.argmax(scores, dim=1).cpu().numpy()], result


def _optax_probe(train_features, train_labels, val_features, val_labels,
                 steps: int = 500, lr: float = 1e-2, device=None):
    """On-device multinomial logistic regression: Adam, full batch."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(train_features, np.float32)).to(device)
    y = torch.as_tensor(np.asarray(train_labels).astype(np.int64)).to(device)
    num_classes = int(np.asarray(train_labels).max()) + 1
    mean, std = x.mean(0), x.std(0, unbiased=False) + 1e-6
    x = (x - mean) / std

    params = [torch.zeros(x.shape[1], num_classes, device=device, requires_grad=True),
              torch.zeros(num_classes, device=device, requires_grad=True)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, steps + 1):
        w, b = params
        logits = x @ w + b
        loss = (torch.nn.functional.cross_entropy(logits, y)
                + 1e-4 * torch.sum(w ** 2))
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                m_hat = m / (1 - b1 ** t)
                v_hat = v / (1 - b2 ** t)
                p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))

    with torch.no_grad():
        xv = (torch.as_tensor(np.asarray(val_features, np.float32)).to(device) - mean) / std
        preds = torch.argmax(xv @ params[0] + params[1], dim=-1).cpu().numpy()
    accuracy = float((preds == np.asarray(val_labels)).mean())
    return preds, accuracy
