"""Table-2 study: MLP predictors vs the comparator PTW-CP; port of
``repro.core.ptwcp_nn``.

The paper trains NN-10/NN-5/NN-2 on per-page features to classify
"top-30% most costly-to-translate" pages, then distills NN-2's decision
boundary into the 4-comparator box.  The pipeline is rebuilt on features
collected by the simulator (``cfg.collect``): NN-6 (all available
features, the NN-10 stand-in), NN-4, NN-2 (freq+cost only), and the
comparator.

``build_dataset``, ``_metrics``, ``comparator_result`` and ``fit_box``
are the reference's numpy code.  ``train_mlp`` trains a torch MLP by
plain full-batch gradient descent with the reference's loss, step size,
step count and normalisation, on the card unless the caller passes
``device="cpu"``.  Its initial weights come from a ``torch.Generator``
seeded with ``seed``, or from ``init``: ``(w, b)`` numpy arrays in the
reference's layout, which is how the reference's ``jax.random`` draw is
carried across.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ptwcp
from repro_torch.core.mmu import resolve_device

LR = 0.05
STEPS = 300
# (name, feature columns, hidden width) of the study's MLPs, in order
MLPS = (("NN-6", [0, 1, 2, 3, 4, 5], 16), ("NN-4", [1, 2, 3, 5], 8),
        ("NN-2", [1, 2], 4))


def build_dataset(extras_list):
    """From collect-mode extras: features + labels per touched page."""
    Xs, ys = [], []
    for ex in extras_list:
        ft = ex["feats"]
        pc = ex["pc4"]
        touched = np.asarray(ft.n_access) > 0
        idx = np.nonzero(touched)[0]
        freq = np.asarray(pc.freq)[: len(ft.n_access)][idx]
        cost = np.asarray(pc.cost)[: len(ft.n_access)][idx]
        feats = np.stack([
            np.asarray(ft.is2m)[idx].astype(np.float32),
            np.minimum(freq, 7).astype(np.float32),
            np.minimum(cost, 15).astype(np.float32),
            np.minimum(np.asarray(ft.n_access)[idx], 63).astype(np.float32),
            np.minimum(np.asarray(ft.n_l1_miss)[idx], 31).astype(np.float32),
            np.minimum(np.asarray(ft.n_l2_miss)[idx], 31).astype(np.float32),
        ], axis=1)
        wc = np.asarray(ft.walk_cyc)[idx]
        walked = wc > 0
        # top-30% most costly among pages that walked at all (paper §5.2)
        thr = np.quantile(wc[walked], 0.70) if walked.any() else 1.0
        Xs.append(feats)
        ys.append((wc >= max(thr, 1.0)).astype(np.float32))
    return np.concatenate(Xs), np.concatenate(ys)


@dataclasses.dataclass
class NNResult:
    name: str
    params_bytes: int
    accuracy: float
    precision: float
    recall: float
    f1: float


def _metrics(pred, y):
    tp = float(((pred == 1) & (y == 1)).sum())
    tn = float(((pred == 0) & (y == 0)).sum())
    fp = float(((pred == 1) & (y == 0)).sum())
    fn = float(((pred == 0) & (y == 1)).sum())
    acc = (tp + tn) / max(len(y), 1)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return acc, prec, rec, f1


def init_weights(dims, seed: int = 0):
    """Initial ``(w, b)`` layers, ``w ~ N(0, 1) / sqrt(fan_in)`` from a
    ``torch.Generator`` seeded with ``seed``, ``b = 0`` (float32, CPU)."""
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(dims[i], dims[i + 1], generator=gen)
             / np.sqrt(dims[i]), torch.zeros(dims[i + 1]))
            for i in range(len(dims) - 1)]


def _forward(ws, x):
    for w, b in ws[:-1]:
        x = torch.relu(x @ w + b)
    w, b = ws[-1]
    return (x @ w + b)[:, 0]


def train(X, y, feat_idx, hidden, layers=2, steps=STEPS, seed=0,
          device=None, init=None):
    """The MLP's final ``(w, b)`` layers and its 0/1 predictions on the
    training set (numpy), after ``steps`` full-batch gradient steps."""
    dev = resolve_device(device)
    Xs = torch.as_tensor(np.ascontiguousarray(X[:, feat_idx]),
                         dtype=torch.float32, device=dev)
    mu, sd = Xs.mean(0), Xs.std(0, correction=0) + 1e-6
    Xs = (Xs - mu) / sd
    yv = torch.as_tensor(y, dtype=torch.float32, device=dev)
    dims = [len(feat_idx)] + [hidden] * layers + [1]
    if init is None:
        init = init_weights(dims, seed)
    ws = []
    for (w, b), (i, o) in zip(init, zip(dims[:-1], dims[1:])):
        w = torch.tensor(np.asarray(w, np.float32), device=dev)
        b = torch.tensor(np.asarray(b, np.float32), device=dev)
        if tuple(w.shape) != (i, o) or tuple(b.shape) != (o,):
            raise ValueError(f"init layer {tuple(w.shape)}, "
                             f"{tuple(b.shape)}: want ({i}, {o}), ({o},)")
        ws.append((w.requires_grad_(), b.requires_grad_()))
    params = [p for wb in ws for p in wb]
    for _ in range(steps):
        logit = _forward(ws, Xs)
        loss = torch.mean(torch.relu(logit) - logit * yv
                          + torch.log1p(torch.exp(-logit.abs())))
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p -= LR * g
    with torch.no_grad():
        pred = (torch.sigmoid(_forward(ws, Xs)) > 0.5).float()
    return ([(w.detach().cpu().numpy(), b.detach().cpu().numpy())
             for w, b in ws], pred.cpu().numpy())


def train_mlp(X, y, feat_idx, hidden, layers=2, steps=STEPS, seed=0,
              name="NN", device=None, init=None) -> NNResult:
    """Tiny MLP trained by full-batch gradient descent on the label."""
    ws, pred = train(X, y, feat_idx, hidden, layers, steps, seed, device,
                     init)
    acc, prec, rec, f1 = _metrics(pred, y)
    nbytes = int(sum(w.size + b.size for w, b in ws) * 4)
    return NNResult(name, nbytes, acc, prec, rec, f1)


def comparator_result(X, y, box=None, name="Comparator(paper-box)"
                      ) -> NNResult:
    freq, cost = X[:, 1], X[:, 2]
    clo, chi, flo, fhi = box or (ptwcp.BOX_COST_LO, ptwcp.BOX_COST_HI,
                                 ptwcp.BOX_FREQ_LO, ptwcp.BOX_FREQ_HI)
    pred = ((cost >= clo) & (cost <= chi)
            & (freq >= flo) & (freq <= fhi)).astype(np.float32)
    acc, prec, rec, f1 = _metrics(pred, y)
    return NNResult(name, 24, acc, prec, rec, f1)


def fit_box(X, y):
    """The paper distills its comparator box from NN-2's decision pattern
    (Fig. 16); on time-compressed traces the counters saturate at
    different rates, so the 4 thresholds are refit the same way
    (exhaustive search over the 16×16×8×8 grid, F1 objective)."""
    freq, cost = X[:, 1], X[:, 2]
    best, best_f1 = (1, 12, 1, 7), -1.0
    for clo in range(0, 8):
        for chi in range(clo, 16):
            for flo in range(0, 8):
                pred = ((cost >= clo) & (cost <= chi)
                        & (freq >= flo)).astype(np.float32)
                _, _, _, f1 = _metrics(pred, y)
                if f1 > best_f1:
                    best_f1, best = f1, (clo, chi, flo, 7)
    return best


def run_study(extras_list, device=None, inits=None):
    """The five predictors in the reference's order.  ``inits`` maps an
    MLP's name (``MLPS``) to its initial layers; the others draw theirs
    from the seeded generator."""
    inits = inits or {}
    X, y = build_dataset(extras_list)
    box = fit_box(X, y)
    return [train_mlp(X, y, idx, hidden=h, name=name, device=device,
                      init=inits.get(name))
            for name, idx, h in MLPS] + [
        comparator_result(X, y),
        comparator_result(X, y, box, name=f"Comparator(refit {box})"),
    ]
