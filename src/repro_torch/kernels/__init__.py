"""StruM kernels for Hopper (CUDA C++ under ``csrc/``, built by ``build``).

``strum_matmul`` holds kernels K1-K3 (packed-weight matmul) and K6-K8
(the same over stacked MoE expert weights),
``strum_attention`` K4-K5 (the sealed-page partial of paged attention over
packed KV pools) and ``strum_decode`` K11 (packed page decode), each with
its plain PyTorch version and launch counts; ``ops`` holds the matmul's
public wrappers (``ops.strum_matmul``, ``ops.strum_gemv``,
``ops.strum_grouped_matmul``), ``ref`` the
dequantize-then-matmul oracles.  The wrappers are not re-exported here, so
each kernel module stays the place its kernels live.
"""
