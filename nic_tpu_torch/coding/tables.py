"""Quantized-CDF table construction for the rANS coder (a copy of
nic_tpu/coding/tables.py).

Host-side counterpart of tfc's pmf_to_quantized_cdf C++ op: converts float
PMF rows (from FactorizedEntropyModel.pmf_for_coding or
GaussianConditional.pmfs_for_coding) into integer cumulative tables with
total mass 2^precision and no zero-frequency slots, appending an escape slot
that absorbs the tail mass for out-of-range symbols.
"""

from dataclasses import dataclass

import numpy as np

from nic_tpu_torch.config import CODER_PRECISION


def pmf_to_quantized_cdf(
    pmf: np.ndarray, tail: np.ndarray, lengths: np.ndarray, precision: int = CODER_PRECISION
):
    """Quantize PMF rows to integer CDFs.

    Args:
      pmf: (R, L) float PMF rows; entries beyond lengths[r] are ignored.
      tail: (R,) leftover mass per row, assigned to the escape slot.
      lengths: (R,) number of real symbols per row.
      precision: CDF precision in bits.

    Returns:
      cdfs: (R, max_size + 1) uint32, row r valid through cdf_sizes[r];
            cdf[0] == 0, cdf[size] == 2^precision.
      cdf_sizes: (R,) int32 = lengths + 1 (escape slot appended).
      offsets is the caller's business (symbol = value - offset).
    """
    pmf = np.asarray(pmf, np.float64)
    tail = np.asarray(tail, np.float64)
    lengths = np.asarray(lengths, np.int64)
    num_rows = pmf.shape[0]
    sizes = (lengths + 1).astype(np.int32)
    max_size = int(sizes.max())
    total = 1 << precision
    cdfs = np.zeros((num_rows, max_size + 1), np.uint32)

    for r in range(num_rows):
        L = int(lengths[r])
        p = np.empty(L + 1, np.float64)
        p[:L] = np.maximum(pmf[r, :L], 0.0)
        p[L] = max(float(tail[r]), 0.0)
        s = p.sum()
        if s <= 0:
            p[:] = 1.0 / (L + 1)
        else:
            p /= s
        freq = np.maximum(np.round(p * total).astype(np.int64), 1)
        # Rebalance to hit exactly 2^precision: steal from / add to the
        # largest entries, which perturbs the rate least.
        diff = total - int(freq.sum())
        while diff != 0:
            if diff > 0:
                idx = int(np.argmax(p - freq / total))
                freq[idx] += 1
                diff -= 1
            else:
                candidates = np.where(freq > 1)[0]
                idx = candidates[int(np.argmax(freq[candidates]))]
                take = min(int(freq[idx]) - 1, -diff)
                freq[idx] -= take
                diff += take
        cdfs[r, 1 : L + 2] = np.cumsum(freq).astype(np.uint32)
        # Pad the remainder so every row ends in 2^precision (harmless).
        cdfs[r, L + 2 :] = total
    return cdfs, sizes


def pmf_to_quantized_cdf_fast(pmf: np.ndarray, precision: int = CODER_PRECISION):
    """Vectorized CDF quantization for many equal-length rows (no escape).

    Used for the per-element posterior tables of the bits-back coder, where
    Python-loop quantization of tens of thousands of rows would dominate.
    Every slot gets frequency >= 1; the total is balanced on the largest
    bin (with a loop fallback for pathological rows).

    Returns (cdfs uint32 (R, B+1), sizes int32 (R,) == B).
    """
    pmf = np.asarray(pmf, np.float64)
    rows, bins = pmf.shape
    total = 1 << precision
    p = np.maximum(pmf, 0.0)
    s = p.sum(axis=1, keepdims=True)
    p = np.where(s > 0, p / np.maximum(s, 1e-300), 1.0 / bins)
    freq = np.maximum(np.round(p * total).astype(np.int64), 1)
    resid = total - freq.sum(axis=1)
    top = np.argmax(freq, axis=1)
    freq[np.arange(rows), top] += resid
    bad = freq[np.arange(rows), top] < 1
    if bad.any():
        for r in np.nonzero(bad)[0]:
            f = np.maximum(np.round(p[r] * total).astype(np.int64), 1)
            d = total - f.sum()
            while d != 0:
                if d > 0:
                    f[np.argmax(p[r] - f / total)] += 1
                    d -= 1
                else:
                    i = np.argmax(f)
                    take = min(int(f[i]) - 1, -d)
                    f[i] -= take
                    d += take
            freq[r] = f
    cdfs = np.zeros((rows, bins + 1), np.uint32)
    cdfs[:, 1:] = np.cumsum(freq, axis=1).astype(np.uint32)
    return cdfs, np.full(rows, bins, np.int32)


@dataclass
class CdfTable:
    """A ready-to-code table: quantized CDFs + per-row symbol offsets."""

    cdfs: np.ndarray       # (R, max_size + 1) uint32
    cdf_sizes: np.ndarray  # (R,) int32 (includes escape slot)
    offsets: np.ndarray    # (R,) int32: symbol index = value - offsets[row]

    @classmethod
    def from_pmf(cls, pmf, offsets, lengths, tail, precision: int = CODER_PRECISION):
        pmf = np.asarray(pmf)
        cdfs, sizes = pmf_to_quantized_cdf(pmf, tail, np.asarray(lengths), precision)
        return cls(cdfs=cdfs, cdf_sizes=sizes, offsets=np.asarray(offsets, np.int32))

    def symbols_from_values(self, values: np.ndarray, indexes: np.ndarray) -> np.ndarray:
        """Map integer values to row-relative symbol indexes."""
        return values.astype(np.int32) - self.offsets[indexes]

    def values_from_symbols(self, symbols: np.ndarray, indexes: np.ndarray) -> np.ndarray:
        return symbols + self.offsets[indexes]
