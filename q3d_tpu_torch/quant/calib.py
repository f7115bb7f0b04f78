"""Host-side amax resolution from a quantizer's calibration histogram (port
of ``compute_amax_from_hist`` and ``_entropy_amax``,
``q3d_tpu/quant/tensor_quant.py:206-281``).

numpy on the host, as the reference runs them: ``max`` (the top filled
bin's edge), ``percentile``, ``mse`` (the quantization error on bin centres)
and ``entropy`` (TensorRT's KL-divergence sweep, scipy's ``entropy``).

``_entropy_amax`` builds each candidate's 128-level distribution from
running sums of the bins and ``np.repeat`` where the reference loops over
the levels in Python.  The histogram holds integer counts, so every sum of
bins is exact in float64 whatever its order, and the arrays handed to
``expanded.sum()`` and the divergence are bit-for-bit the reference's: the
result is equal (``tests/test_torch_port_fakequant.py`` holds it equal on
seeded histograms).  The divergence is scipy's ``entropy(p, q)`` written
out op for op (``_relative_entropy``): scipy's array-API wrapper costs
~1 ms a call, and the sweep makes ~1,900 calls a histogram.
"""

import functools

import numpy as np


def compute_amax_from_hist(hist, bin_width, method="entropy", *, num_bits=8,
                           percentile=99.99, start_bin=128, stride=1):
    """Resolve amax from a 2048-bin absmax histogram (numpy)."""
    hist = np.asarray(hist, np.float64)
    bin_width = float(bin_width)
    nbins = len(hist)
    centers = (np.arange(nbins) + 0.5) * bin_width
    if method == "max":
        nz = np.nonzero(hist)[0]
        return float((nz[-1] + 1) * bin_width) if len(nz) else 0.0
    if method == "percentile":
        total = hist.sum()
        if total == 0:
            return 0.0
        cdf = np.cumsum(hist) / total
        idx = np.searchsorted(cdf, percentile / 100.0)
        return float((min(idx, nbins - 1) + 1) * bin_width)
    if method == "mse":
        bound = 2.0 ** (num_bits - 1) - 1.0
        best_amax, best_mse = centers[-1], np.inf
        for i in range(start_bin, nbins, max(stride, 8)):
            amax = (i + 0.5) * bin_width
            scale = bound / amax
            q = np.clip(np.round(centers * scale), -bound, bound) / scale
            mse = float((hist * (centers - q) ** 2).sum())
            if mse < best_mse:
                best_mse, best_amax = mse, amax
        return float(best_amax)
    if method == "entropy":
        return _entropy_amax(hist, bin_width, num_bits=num_bits,
                             start_bin=start_bin, stride=stride)
    raise ValueError(f"unknown amax method {method}")


def _relative_entropy(pk, qk):
    """``scipy.stats.entropy(pk, qk)`` of two 1-D float64 arrays, op for op
    as scipy 1.17 computes it: each normalised by its sum, then the sum of
    ``rel_entr``."""
    from scipy.special import rel_entr
    with np.errstate(invalid="ignore"):
        qk = qk / np.sum(qk, axis=0, keepdims=True)
        pk = pk / np.sum(pk, axis=0, keepdims=True)
    return np.sum(rel_entr(pk, qk), axis=0)


@functools.lru_cache(maxsize=None)
def _level_edges(i, levels):
    """The first bin of each of ``levels`` target levels over ``i`` bins,
    and ``i`` (the reference's ``np.linspace(0, i, levels + 1)``)."""
    return np.linspace(0, i, num=levels + 1, dtype=np.int64)


def _entropy_amax(hist, bin_width, num_bits=8, start_bin=128, stride=1):
    """TensorRT-style KL calibration (pytorch_quantization's
    ``HistogramCalibrator._compute_amax_entropy``).  The bins hold integer
    counts, so the candidate distribution's total (every candidate's is the
    histogram's), its clamped last bin and the levels' sums and nonzero
    counts come from running sums, exactly; the expanded distribution's sum
    and the divergence take the reference's arrays as they are."""
    nbins = len(hist)
    levels = 1 << (num_bits - 1)  # 128 target levels for signed int8
    starting = max(start_bin, levels)
    best_div, best_i = np.inf, nbins
    bins = hist.astype(np.float64).copy()
    bins[0] = bins[1] if nbins > 1 else bins[0]  # zero-bin smoothing

    nonzero = bins != 0
    total = bins.sum()
    if total == 0:
        return float(best_i * bin_width)
    csum = np.concatenate([[0.0], np.cumsum(bins)])
    cnz = np.concatenate([[0], np.cumsum(nonzero)])
    for i in range(starting, nbins + 1, stride):
        # quantize the i-bin distribution down to `levels` bins and expand
        space = _level_edges(i, levels)
        q = csum[space[1:]] - csum[space[:-1]]
        nnz = cnz[space[1:]] - cnz[space[:-1]]
        share = np.repeat(q / np.maximum(nnz, 1), np.diff(space))
        expanded = np.where(nonzero[:i], share, 0.0)
        esum = expanded.sum()
        if esum == 0:
            continue
        p = bins[:i] / total
        # the outliers clamped into the last bin
        p[i - 1] = (bins[i - 1] + (total - csum[i])) / total
        qn = expanded / esum
        div = _relative_entropy(p, np.where(qn == 0, 1e-12, qn))
        if div <= best_div:
            best_div, best_i = div, i
    return float(best_i * bin_width)
