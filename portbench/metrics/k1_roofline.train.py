"""K1's least time for the steps' emulated GEMMs over its traced device time."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "train_k1_bound_s", "split_gemm_kernel",
                            "split_gemm", "train_real_gemms")
