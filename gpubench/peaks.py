"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W; the card's power limit is printed beside every run) and the
least time of the SPD factor-and-solve. Copied from chip_smoke.py
(:166-170 the peaks, :429-434 ``bound``, :463-469 ``chol_bound``), with the
word size as an argument."""

PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_F64_TC_FLOPS = 67e12  # float64 on the tensor cores (DMMA), the higher
PEAK_BYTES = 3.35e12  # HBM3


def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    """(least time in ms, what bounds it) against ``peak`` and the memory
    peak."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def chol_bound(B, n, K, word=4):
    """One factor-and-solve of B instances: n^3/3 FLOPs for the factor and
    2 n^2 K for the two substitutions; the upper triangle of A (n (n + 1) / 2
    words, all that is read of it) and RHS read once, X written once; words
    of ``word`` bytes (float64: the card's higher float64 rate)."""
    peak = PEAK_F64_TC_FLOPS if word == 8 else PEAK_F32_FLOPS
    return bound(B * (n**3 / 3 + 2 * n * n * K),
                 word * B * (n * (n + 1) // 2 + 2 * n * K), peak)
