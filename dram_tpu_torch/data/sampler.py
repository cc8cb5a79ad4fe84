"""Class-balanced samplers over lobe-chunk datasets (NumPy).

Port of dram_tpu/data/sampler.py: `balanced_class_weights` (:15),
`LobeChunkCTSSSampler` (:22) and `LobeChunkCLESampler` (:73). A sampler
is an iterable of dataset indices with two statistics the
interval-regression loss reads: `class_weights` and `ctss_frequency_map`
(count / total per label, 1e-5 for an absent label). Draws come from
`np.random.default_rng(seed)`, so a seed gives the JAX package's
sequence; the CLE sampler's stratified batch order is drawn from the
same generator (the JAX package calls sklearn's StratifiedShuffleSplit
without a seed there, so its order repeats nowhere).
"""

from __future__ import annotations

import numpy as np


def balanced_class_weights(labels):
    """sklearn's 'balanced' heuristic: n_samples / (n_classes * count).
    Returns (classes, counts, weights)."""
    labels = np.asarray(labels)
    classes, counts = np.unique(labels, return_counts=True)
    return classes, counts, len(labels) / (len(classes) * counts.astype(np.float64))


def _fill_absent(class_weights, frequency_map, labels):
    for t in range(6):
        if t not in labels:
            class_weights.insert(t, max(class_weights))
            frequency_map[t] = 1e-5


def _frequency_array(frequency_map):
    """(6,) float32 frequencies for the loss."""
    return np.asarray([frequency_map.get(i, 1e-5) for i in range(6)],
                      np.float32)


class LobeChunkCTSSSampler:
    """Per-epoch resampling: `balance_label_count` draws per present CTSS
    label (the median label count by default), each a label drawn
    uniformly, then a chunk of that label drawn uniformly."""

    def __init__(self, logger, data_source, batch_size,
                 balance_label_count=None, seed=None):
        self.data_source = data_source
        self.batch_size = batch_size
        self.logger = logger
        self.rng = np.random.default_rng(seed)

        self.ctsses = np.asarray([
            int(float(data_source.all_metas[uid]["ctss"]))
            for uid in data_source.uids])
        self.ctss_labels, self.ctss_counts, cws = \
            balanced_class_weights(self.ctsses)
        self.class_weights = list(cws)
        total = np.sum(self.ctss_counts)
        self.ctss_frequency_map = {int(cl): cnt / total for cl, cnt
                                   in zip(self.ctss_labels, self.ctss_counts)}
        _fill_absent(self.class_weights, self.ctss_frequency_map,
                     self.ctss_labels)

        if balance_label_count is None:
            balance_label_count = int(np.median(self.ctss_counts))
        self.balance_label_count = balance_label_count
        self.total_n = self.balance_label_count * len(self.ctss_labels)
        self.grouped = {int(l): np.where(self.ctsses == l)[0]
                        for l in self.ctss_labels}
        if logger is not None:
            logger.info(f"CTSS distribution {self.ctss_labels}-{self.ctss_counts}; "
                        f"sampling {self.total_n} chunks/epoch")

    def frequency_array(self):
        return _frequency_array(self.ctss_frequency_map)

    def __iter__(self):
        out = []
        for _ in range(self.total_n):
            label = int(self.rng.choice(self.ctss_labels))
            out.append(int(self.rng.choice(self.grouped[label])))
        return iter(out)

    def __len__(self):
        return self.total_n


def stratified_groups(rng, y, test_size, n_splits):
    """`n_splits` stratified draws of `test_size` positions of the labels
    `y`, concatenated: in each draw every label gets its proportional
    share of `test_size` rounded down, the remainder going one each to the
    labels with the largest fractional shares (ties drawn at random); each
    label's positions are drawn without replacement and the draw is
    shuffled. The procedure of sklearn's StratifiedShuffleSplit test
    folds, from `rng`."""
    y = np.asarray(y)
    if not 0 < test_size < len(y):
        # sklearn raises too: the train fold would be empty
        raise ValueError(f"test_size={test_size} must lie in (0, "
                         f"{len(y)}), the number of picks")
    classes, counts = np.unique(y, return_counts=True)
    share = counts * (test_size / len(y))
    base = np.floor(share).astype(int)
    frac = share - base
    out = []
    for _ in range(n_splits):
        take = base.copy()
        rest = test_size - int(take.sum())
        if rest > 0:
            order = np.lexsort((rng.random(len(classes)), -frac))
            take[order[:rest]] += 1
        group = np.concatenate([
            rng.permutation(np.where(y == c)[0])[:t]
            for c, t in zip(classes, take)])
        out.extend(rng.permutation(group).tolist())
    return out


class LobeChunkCLESampler:
    """COPDGene chunks: `balance_label_count` chunks drawn with
    replacement per present CLE label (the median count by default), then
    ordered in stratified groups of max(2 * batch_size, n_labels), one
    group per `len // group` (stratified_groups). Class weights are the
    balanced ones normalised and clipped to [0.2, 0.8]."""

    def __init__(self, logger, data_source, batch_size,
                 balance_label_count=None, seed=None):
        self.rng = np.random.default_rng(seed)
        cles = np.asarray([int(float(data_source.meta[uid]["cle"]))
                           for uid in data_source.uids])
        labels, counts, cws = balanced_class_weights(cles)
        cws = np.clip(cws / cws.sum(), 0.2, 0.8)
        self.class_weights = list(cws)
        total = counts.sum()
        self.ctss_frequency_map = {int(l): c / total
                                   for l, c in zip(labels, counts)}
        _fill_absent(self.class_weights, self.ctss_frequency_map, labels)
        if balance_label_count is None:
            balance_label_count = int(np.median(counts))

        sampling_indices, sampling_labels = [], []
        for l in labels:
            locs = np.where(cles == l)[0]
            pick = self.rng.choice(locs, balance_label_count)
            sampling_indices.extend(pick.tolist())
            sampling_labels.extend([l] * balance_label_count)
        self.balanced_picks = list(sampling_indices)

        y = np.asarray(sampling_labels)
        test_size = max(int(batch_size * 2), len(np.unique(y)))
        n_splits = max(1, len(y) // test_size)
        order = stratified_groups(self.rng, y, test_size, n_splits)
        self.indices = [sampling_indices[i] for i in order]
        if logger is not None:
            logger.info(f"CLE distribution {labels}-{counts}; sampling "
                        f"{len(self.indices)} chunks/epoch")

    def frequency_array(self):
        return _frequency_array(self.ctss_frequency_map)

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)
