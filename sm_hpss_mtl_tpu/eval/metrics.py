"""Classification metrics matching ``misc.getPerformance``
(``/root/reference/lib/misc.py:95-103``): the confusion matrix and
per-class precision/recall/F1 rounded to 4 places, with sklearn's
semantics (rows = truth, columns = prediction, in ``labels`` order;
samples whose truth or prediction is not in ``labels`` are ignored; a
zero denominator gives 0)."""

from __future__ import annotations

import numpy as np


def confusion_matrix(y_true, y_pred, labels) -> np.ndarray:
    labels = list(labels)
    index = {lab: i for i, lab in enumerate(labels)}
    conf = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(np.asarray(y_true).tolist(), np.asarray(y_pred).tolist()):
        if t in index and p in index:
            conf[index[t], index[p]] += 1
    return conf


def _ratio(num, den):
    num = num.astype(np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den > 0)


def get_performance(pred_labels, ground_truth, labels):
    conf = confusion_matrix(ground_truth, pred_labels, labels)
    # Precision and recall count every prediction / truth of a class in
    # ``labels``, including those paired with a label outside it.
    y_true, y_pred = np.asarray(ground_truth), np.asarray(pred_labels)
    tp = np.diag(conf)
    n_pred = np.array([np.sum(y_pred == lab) for lab in labels])
    n_true = np.array([np.sum(y_true == lab) for lab in labels])
    precision = _ratio(tp, n_pred)
    recall = _ratio(tp, n_true)
    fscore = _ratio(2 * precision * recall, precision + recall)
    return (conf, np.round(precision, 4), np.round(recall, 4),
            np.round(fscore, 4))


def accuracy(conf: np.ndarray) -> float:
    return float(np.round(np.sum(np.diag(conf)) / max(np.sum(conf), 1), 4))
